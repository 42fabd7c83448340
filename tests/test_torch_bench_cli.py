"""The port's fixture writer, reporting and bench CLIs against the JAX
package's: the fixture tree byte for byte, the rosters and their
resolution, every reporting line and CSV column, and ``inverse_bench`` /
``gauss_bench`` with ``--device cpu`` read by JAX's ``parse_csv_rows``,
their host rows' L1 errors equal to JAX's.

Inputs are drawn from ``np.random.default_rng(seed)`` here, never from the
session ``rng`` fixture.
"""

import filecmp
import io
import os
from pathlib import Path

import numpy as np
import pytest

from cuda_matrix_inversion_tpu.bench import gauss_bench as jax_gauss_bench
from cuda_matrix_inversion_tpu.bench import inverse_bench as jax_inverse_bench
from cuda_matrix_inversion_tpu.bench import reporting as jax_reporting
from cuda_matrix_inversion_tpu.io import fixtures as jax_fixtures
from cuda_matrix_inversion_tpu.utils import errors as jax_errors
from cuda_matrix_inversion_tpu.utils import timer as jax_timer
from cuda_matrix_inversion_tpu_torch.bench import (
    gauss_bench,
    inverse_bench,
    reporting,
)
from cuda_matrix_inversion_tpu_torch.io import fixtures
from cuda_matrix_inversion_tpu_torch.native import oracle
from cuda_matrix_inversion_tpu_torch.ops.registry import list_inverse_algorithms
from cuda_matrix_inversion_tpu_torch.utils import errors, timer

HAND = str(Path(__file__).resolve().parent / "hand_fixtures")


def _same_tree(left: str, right: str) -> None:
    """Every file under ``left`` and ``right``, by relative path and
    bytes."""
    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    assert files(left) == files(right)
    for rel in files(left):
        assert filecmp.cmp(os.path.join(left, rel), os.path.join(right, rel),
                           shallow=False), rel


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("fixtures")
    fixtures.generate_all(str(root), dims=(8,), num=12, seed=5)
    return root


@pytest.mark.parametrize("seed", [0, 3])
def test_generate_all_is_byte_identical_to_jax(tmp_path, seed):
    fixtures.generate_all(str(tmp_path / "port"), dims=(4, 8), num=10,
                          seed=seed)
    jax_fixtures.generate_all(str(tmp_path / "jax"), dims=(4, 8), num=10,
                              seed=seed)
    _same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_fixture_cli_is_byte_identical_to_jax(tmp_path):
    argv = ["--dims", "4", "8", "--num", "7", "--seed", "2"]
    assert fixtures.main([str(tmp_path / "port"), *argv]) == 0
    assert jax_fixtures.main([str(tmp_path / "jax"), *argv]) == 0
    _same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert (tmp_path / "port" / "square_5_8x8" / "aInv.mats").exists()


def test_singular_demo_batch_equals_jax():
    assert np.array_equal(fixtures.singular_demo_batch(),
                          jax_fixtures.singular_demo_batch())


def test_rosters_equal_jax():
    assert inverse_bench.DEFAULT_ALGORITHMS == (
        jax_inverse_bench.DEFAULT_ALGORITHMS)
    assert inverse_bench.GENERAL_ALGORITHMS == (
        jax_inverse_bench.GENERAL_ALGORITHMS)
    assert inverse_bench.OPTIONAL_ALGORITHMS == (
        jax_inverse_bench.OPTIONAL_ALGORITHMS)


@pytest.mark.parametrize("requested", [
    ["lu,lu_pallas", "gauss_cpu"],
    ["lu_native_cpu", "lu", "cholesky_native_cpu"],
    list(inverse_bench.DEFAULT_ALGORITHMS),
])
def test_resolve_algorithms_like_jax(requested):
    """Comma lists split, an unbuilt optional row dropped silently."""
    available = {"lu", "lu_pallas", "gauss_cpu", "lu_cpu", "cholesky_cpu",
                 "cholesky", "gauss_pallas", "cholesky_pallas",
                 "newton_schulz_pallas", "newton_schulz_spd_pallas",
                 "newton_schulz_spd10_pallas"}
    got = inverse_bench.resolve_algorithms(requested, available)
    assert got == jax_inverse_bench.resolve_algorithms(requested, available)
    assert "lu_native_cpu" not in got


def test_resolve_algorithms_rejects_an_unknown_name_like_jax():
    with pytest.raises(errors.EnsureError) as got:
        inverse_bench.resolve_algorithms(["lu", "bogus"], {"lu"})
    with pytest.raises(jax_errors.EnsureError) as ref:
        jax_inverse_bench.resolve_algorithms(["lu", "bogus"], {"lu"})
    assert str(got.value) == str(ref.value)


def test_errors_helpers_equal_jax():
    assert [errors.div_ceil(a, 4) for a in range(9)] == [
        jax_errors.div_ceil(a, 4) for a in range(9)]
    with pytest.raises(errors.EnsureError, match="x=3"):
        errors.ensure(False, "x=%d", 3)
    errors.ensure(True, "never")


@pytest.mark.parametrize("ms", [0.0, 3e-4, 9.99e-3, 0.01, 1.5, 1234.5678])
def test_format_ms_equals_jax(ms):
    assert reporting.format_ms(ms) == jax_reporting.format_ms(ms)


def test_error_metrics_equal_jax():
    rng = np.random.default_rng(31)
    a = fixtures.make_spd_batch(4, 6, rng).astype(np.float32)
    x = np.linalg.inv(a).astype(np.float32)
    ref = np.linalg.inv(a.astype(np.float64))
    assert reporting.l1_total(x, ref) == jax_reporting.l1_total(x, ref)
    assert reporting.l1_error(x, ref, 4) == jax_reporting.l1_error(x, ref, 4)
    assert reporting.identity_error_inf(a, x) == (
        jax_reporting.identity_error_inf(a, x))


def test_timer_and_welford_equal_jax():
    samples = [0.0012, 0.0031, 0.0007, 0.0052]
    port, ref = timer.Timer("stage"), jax_timer.Timer("stage")
    for sec in samples:
        port.add(sec)
        ref.stats.add(sec)
        ref.last_seconds = sec
    for attr in ("count", "mean", "total", "variance", "stddev"):
        assert getattr(port.stats, attr) == getattr(ref.stats, attr)
    assert port.log_line(100, 128) == ref.log_line(100, 128)
    port.start()
    assert port.stop() >= 0.0 and port.stats.count == len(samples) + 1


@pytest.mark.parametrize("csv", [True, False])
@pytest.mark.parametrize("reps", [1, 3])
def test_bench_reporter_lines_equal_jax(csv, reps):
    """With the same timer samples and errors, the port's reporter prints
    the JAX reporter's lines, extra metrics included."""
    out = {}
    for key, module in (("port", reporting), ("jax", jax_reporting)):
        buf = io.StringIO()
        rep = module.BenchReporter(100, 128, reps, csv=csv, stream=buf)
        for i, name in enumerate(("lu_cpu", "lu_pallas", "means_gpu")):
            entry = rep.entry(name)
            for r in range(reps):
                entry.timer.stats.add(1e-3 * (i + 1) + 1e-5 * r)
            entry.total_error = 3.5e-4 * (i + 1)
            rep.report(name, extra_metrics={"max ||AA^-1 - I||_inf":
                                            f"{1e-6 * (i + 1):.3e}"})
        out[key] = buf.getvalue()
    assert out["port"] == out["jax"]
    assert out["port"].count("\n") == (3 if csv else 6)


def test_csv_tools_equal_jax(tmp_path):
    """``parse_csv_rows``, ``audit_outliers`` and
    ``write_errors_companion`` on one file with both CSV widths, a phase
    line and an outlier."""
    lines = ["100 128 3 lu 3.0e+00 1.0e+00 1.0e-02 2.0e-06",
             "1600 128 3 lu 2.7e+02 9.0e+01 1.0e-01 2.0e-06",
             "100 128 1 lu_cpu 5.0e+01 1.0e-06",
             "calculate_mean_gpu_add,100,128,0.0150,15000",
             "800 128 3 lu 1.5e+01 5.0e+00 1.0e-02 2.0e-06"]
    path = tmp_path / "sweep.csv"
    path.write_text("\n".join(lines) + "\n")
    assert reporting.parse_csv_rows(str(path)) == (
        jax_reporting.parse_csv_rows(str(path)))
    flags = reporting.audit_outliers(str(path))
    assert flags == jax_reporting.audit_outliers(str(path))
    assert [f["num_matrices"] for f in flags] == [1600]
    port = reporting.write_errors_companion(str(path),
                                            str(tmp_path / "port.txt"))
    ref = jax_reporting.write_errors_companion(str(path),
                                               str(tmp_path / "jax.txt"))
    assert Path(port).read_text() == Path(ref).read_text()


def test_print_device_info_names_the_cpu():
    buf = io.StringIO()
    reporting.print_device_info(buf, device="cpu")
    assert buf.getvalue() == "device: cpu\n"


def _rows(text: str, tmp_path: Path, name: str) -> list:
    """The CLI's output read by JAX's ``parse_csv_rows``."""
    path = tmp_path / name
    path.write_text(text)
    return jax_reporting.parse_csv_rows(str(path))


def _jax_rows(run, tmp_path, name, *args, **kwargs):
    buf = io.StringIO()
    run(*args, csv=True, stream=buf, **kwargs)
    return {r["name"]: r for r in _rows(buf.getvalue(), tmp_path, name)}


@pytest.mark.parametrize("folder,dups,reps", [(HAND, 3, 2), ("inverse", 2, 1),
                                              ("square", 1, 2)])
def test_inverse_bench_cli_rows_read_by_jax(tree, tmp_path, capsys, folder,
                                            dups, reps):
    """``main`` with ``--device cpu``: every resolved row, the reference's
    columns (6 at one rep, 8 past it), JAX's L1 error on the host rows,
    the device rows within 1e-4 a matrix of the float64 inverse."""
    roster = (inverse_bench.GENERAL_ALGORITHMS if folder == "square"
              else inverse_bench.DEFAULT_ALGORITHMS)
    if folder != HAND:
        folder = str(tree / (f"square_5_8x8" if folder == "square"
                             else "inverse_12_8x8"))
    argv = [folder, str(reps), str(dups), "-csv", "--device", "cpu",
            "--algorithms", *roster]
    assert inverse_bench.main(argv) == 0
    text = capsys.readouterr().out
    rows = _rows(text, tmp_path, "port.csv")
    want = inverse_bench.resolve_algorithms(roster,
                                            set(list_inverse_algorithms()))
    assert [r["name"] for r in rows] == want
    assert all(len(r["line"].split()) == (8 if reps > 1 else 6) for r in rows)
    host = [n for n in want if n in ("lu_cpu", "cholesky_cpu", "gauss_cpu")]
    ref = _jax_rows(jax_inverse_bench.run_bench, tmp_path, "jax.csv",
                    folder, reps, dups, algorithms=host)
    for r in rows:
        assert r["reps"] == reps and r["num_matrices"] % dups == 0
        if r["name"] in ref:
            assert r["line"].split()[-1] == ref[r["name"]]["line"].split()[-1]
        assert r["err"] < 1e-4, r["name"]


@pytest.fixture(scope="module")
def jax_gauss_rows(tree, tmp_path_factory):
    """JAX's host rows for the solve pipeline and the inverse one (every
    method but ``solve`` takes the latter)."""
    tmp = tmp_path_factory.mktemp("jax_gauss")
    return {method: _jax_rows(jax_gauss_bench.run_bench, tmp, method,
                              str(tree / "gaussian_12_8x8"), 2, 2,
                              method=method, cpu_oracle="scipy")
            for method in ("solve", "inverse")}


@pytest.mark.parametrize("method", gauss_bench.METHODS)
def test_gauss_bench_cli_rows_read_by_jax(tree, tmp_path, capsys,
                                          jax_gauss_rows, method):
    argv = [str(tree / "gaussian_12_8x8"), "2", "2", "-csv", "--method",
            method, "--cpu-oracle", "scipy", "--device", "cpu"]
    assert gauss_bench.main(argv) == 0
    rows = _rows(capsys.readouterr().out, tmp_path, "port.csv")
    assert [r["name"] for r in rows] == ["means_cpu", "variances_cpu",
                                         "means_gpu", "variances_gpu"]
    ref = jax_gauss_rows["solve" if method == "solve" else "inverse"]
    for r in rows:
        assert len(r["line"].split()) == 8 and r["num_matrices"] == 24
        if r["name"].endswith("_cpu"):
            assert r["line"].split()[-1] == ref[r["name"]]["line"].split()[-1]
        assert r["err"] < 1e-4, r["name"]


def test_gauss_bench_stages_fit_and_transfers(tree, tmp_path, capsys):
    """``--stages`` prints the DETAILED_LOGGING lines, ``--fit`` the two fit
    rows (the gradient difference in the K10 row's error column),
    ``--transfers`` times the round trip; human mode names the device."""
    argv = [str(tree / "gaussian_12_8x8"), "2", "1", "--method", "pallas",
            "--stages", "--fit", "--transfers", "--skip-cpu", "--device",
            "cpu"]
    assert gauss_bench.main(argv) == 0
    text = capsys.readouterr().out
    assert text.startswith("device: cpu\n")
    stages = [line.split(",") for line in text.splitlines()
              if line.startswith("calculate_mean_gpu_")]
    assert [s[0] for s in stages] == [
        f"calculate_mean_gpu_{s}" for s in
        ("mem_htod", "add", "inv", "mul", "dot", "mem_dtoh")]
    assert all(s[1:3] == ["12", "8"] and int(s[4]) >= 0 for s in stages)
    for name in ("means_gpu", "variances_gpu", "fit_step_xla",
                 "fit_step_pallas"):
        assert f"{name} - 12 8x8 matrices, replicated 2 times" in text


def test_gauss_bench_native_oracle_flag(tree, monkeypatch, capsys):
    """``--cpu-oracle native`` runs the native rows when the library loads
    and raises when it does not, as JAX's does."""
    argv = [str(tree / "gaussian_12_8x8"), "1", "1", "-csv", "--cpu-oracle",
            "native", "--device", "cpu"]
    if oracle.available():
        assert gauss_bench.main(argv) == 0
        rows = capsys.readouterr().out.splitlines()
        assert [r.split()[3] for r in rows[:2]] == ["means_cpu",
                                                    "variances_cpu"]
        assert all(float(r.split()[-1]) < 1e-4 for r in rows)
    monkeypatch.setattr(oracle, "available", lambda: False)
    with pytest.raises(RuntimeError, match="native oracle"):
        gauss_bench.main(argv)


def test_inverse_bench_exit_code_on_an_unknown_row(capsys):
    assert inverse_bench.main([HAND, "1", "1", "--device", "cpu",
                               "--algorithms", "bogus"]) == 1
    assert "unknown inversion algorithm" in capsys.readouterr().err
