"""GP mean/variance pipeline benchmark CLI.

Counterpart of ``cuda_matrix_inversion_tpu/bench/gauss_bench.py`` and of
the reference's ``src/gauss_bench.cu:577-702``: argv contract
``TEST_FOLDER NUM_REPS NUM_DUPLICATES [-csv]``; it loads the 7 GP fixture
files, replicates them, times the host pipeline and then the device one
for the mean and the variance over the reps, and reports the average
|err| per matrix against ``means.mats`` / ``variances.mats``.

    python -m cuda_matrix_inversion_tpu_torch.bench.gauss_bench \\
        TEST_FOLDER NUM_REPS NUM_DUPLICATES [-csv] [--method ...] \\
        [--stages] [--skip-cpu] [--transfers] [--fit] \\
        [--cpu-oracle auto|scipy|native] [--device cuda|cpu]

Row names are the reference's (``means_cpu``, ``variances_cpu``,
``means_gpu``, ``variances_gpu``, ``results/gauss-bench-errors.txt``).
``--stages`` prints the ``-DDETAILED_LOGGING`` stage split
(``calculate_mean_gpu_{mem_htod,add,inv,mul,dot,mem_dtoh}``, un-fused,
each stage waited for); ``--fit`` times one value-and-grad step of the
mean log marginal likelihood on ``torch.linalg`` (``fit_step_xla``) and on
the fused kernel K10 (``fit_step_pallas``).  Device rows are timed as in
:mod:`.inverse_bench`: one untimed warm-up, then CUDA events a rep;
``--transfers`` times NumPy in → pipeline → NumPy out on the host clock.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from cuda_matrix_inversion_tpu_torch.bench.reporting import (
    BenchReporter,
    l1_total,
    print_device_info,
)
from cuda_matrix_inversion_tpu_torch.io.mats import read_test_folder
from cuda_matrix_inversion_tpu_torch.io.replicate import replicate_matrices
from cuda_matrix_inversion_tpu_torch.models import gp, gp_fit
from cuda_matrix_inversion_tpu_torch.ops import cpu_reference as cpu
from cuda_matrix_inversion_tpu_torch.ops import linalg
from cuda_matrix_inversion_tpu_torch.ops.host_api import resolve_device
from cuda_matrix_inversion_tpu_torch.utils.errors import EnsureError
from cuda_matrix_inversion_tpu_torch.utils.timer import Timer, time_reps

METHODS = ("solve", "inverse", "lu", "newton_schulz", "pallas", "pallas_ns")


def _cpu_pipelines(method: str, cpu_oracle: str):
    """The host rows' mean and variance functions: the native
    C++/LAPACK/OpenMP oracle (``gauss_cpu.c``'s twin) or SciPy's."""
    use_native = False
    if cpu_oracle in ("auto", "native"):
        from cuda_matrix_inversion_tpu_torch.native import oracle

        use_native = oracle.available()
        if cpu_oracle == "native" and not use_native:
            raise RuntimeError(
                "native oracle requested but not built "
                "(python -m cuda_matrix_inversion_tpu_torch.native.build)")
    solve = method == "solve"
    if not use_native:
        if solve:
            return (cpu.calculate_mean_solve_cpu,
                    cpu.calculate_variance_solve_cpu)
        return cpu.calculate_mean_cpu, cpu.calculate_variance_cpu

    # want= selects the reference's single-output workloads, so each row
    # times a factorization and ONE solve, as the original's do
    def mean_fn(a, b, c, d):
        return oracle.gp_mean_variance(
            a, b, c, d, np.zeros(b.shape[0], dtype=b.dtype), solve=solve,
            want="mean")[0].reshape(-1, 1, 1)

    def var_fn(a, b, c, e):
        return oracle.gp_mean_variance(
            a, b, c, a, e, solve=solve, want="variance")[1].reshape(-1, 1, 1)

    return mean_fn, var_fn


def _device_pipelines(method: str):
    """The device rows' mean and variance functions on tensors.  The
    fused methods compute both in one launch; each row keeps the output
    it reports."""
    if method in ("pallas", "pallas_ns"):
        def mean_fn(a, b, c, d):
            e = torch.zeros((a.shape[0], 1, 1), dtype=a.dtype, device=a.device)
            return gp.gp_mean_variance(a, b, c, d, e, method=method)[0]

        def var_fn(a, b, c, e):
            return gp.gp_mean_variance(a, b, c, a, e, method=method)[1]

        return mean_fn, var_fn
    return (lambda a, b, c, d: gp.gp_mean(a, b, c, d, method=method),
            lambda a, b, c, e: gp.gp_variance(a, b, c, e, method=method))


def run_bench(
    folder: str,
    num_reps: int,
    num_duplicates: int,
    csv: bool = False,
    method: str = "solve",
    stages: bool = False,
    skip_cpu: bool = False,
    dtype=np.float32,
    transfers: bool = False,
    stream=None,
    cpu_oracle: str = "auto",
    fit: bool = False,
    device="cuda",
) -> BenchReporter:
    dev = resolve_device(device)
    data = {k: replicate_matrices(v, num_duplicates) for k, v in
            read_test_folder(folder, kind="gaussian", dtype=dtype).items()}
    a, b, c, d, e = (data[k] for k in "abcde")
    means_ref, vars_ref = data["means"], data["variances"]
    num_matrices, n = b.shape[0], b.shape[1]

    stream = stream or sys.stdout
    rep = BenchReporter(num_matrices, n, num_reps, csv=csv, stream=stream)
    if not csv:
        print_device_info(stream, dev)

    # --- host rows (ref calcluateMean[Solve]CPU / ...Variance...) ---
    if not skip_cpu:
        mean_fn, var_fn = _cpu_pipelines(method, cpu_oracle)
        em = rep.entry("means_cpu")
        ev = rep.entry("variances_cpu")
        means = variances = None
        for _ in range(num_reps):
            em.timer.start()
            means = mean_fn(a, b, c, d)
            em.timer.stop()
            ev.timer.start()
            variances = var_fn(a, b, c, e)
            ev.timer.stop()
        em.total_error = l1_total(means, means_ref)
        ev.total_error = l1_total(variances, vars_ref)
        rep.report("means_cpu")
        rep.report("variances_cpu")

    # --- device rows ---
    mean_fn, var_fn = _device_pipelines(method)
    em = rep.entry("means_gpu")
    ev = rep.entry("variances_gpu")
    if transfers:
        def put(*xs):
            return [torch.from_numpy(x).to(dev) for x in xs]

        def mean_trip():
            return mean_fn(*put(a, b, c, d)).cpu().numpy()

        def var_trip():
            return var_fn(*put(a, b, c, e)).cpu().numpy()

        mean_trip(), var_trip()  # the build and first launch stay outside
        means = variances = None
        for _ in range(num_reps):
            em.timer.start()
            means = mean_trip()
            em.timer.stop()
            ev.timer.start()
            variances = var_trip()
            ev.timer.stop()
    else:
        ad, bd, cd, dd, ed = (torch.tensor(x, device=dev)
                              for x in (a, b, c, d, e))
        means = time_reps(em.timer, lambda: mean_fn(ad, bd, cd, dd),
                          num_reps, dev).cpu().numpy()
        variances = time_reps(ev.timer, lambda: var_fn(ad, bd, cd, ed),
                              num_reps, dev).cpu().numpy()
    em.total_error = l1_total(means, means_ref)
    ev.total_error = l1_total(variances, vars_ref)
    rep.report("means_gpu")
    rep.report("variances_gpu")

    if stages:
        _run_stage_split(a, b, c, d, num_matrices, n, stream, dev)
    if fit:
        _run_fit_rows(rep, b, c, d, num_reps, dev)
    return rep


def _run_fit_rows(rep, b, c, d, num_reps, dev):
    """Hyper-parameter-fit step rows (``--fit``).

    Times one value-and-grad step of the mean-LML loss
    (``models/gp_fit.py``) for both LML backends: ``fit_step_xla`` (the
    ``torch.linalg`` Cholesky chain under autograd) and ``fit_step_pallas``
    (K10's fused forward and its analytic backward).  The error column of
    ``fit_step_pallas`` carries the |grad diff| between the two (the
    ``torch.linalg`` chain is the oracle), per matrix like every row."""
    bb, cc, dd = (torch.tensor(x, device=dev) for x in (b, c, d))
    theta0 = torch.zeros((b.shape[0], 2), dtype=bb.dtype, device=dev)
    grads = {}
    for method in ("xla", "pallas"):
        def value_and_grad(method=method):
            theta = theta0.clone().requires_grad_(True)
            loss = -gp_fit._batch_lml(theta, bb, cc, dd, method=method).mean()
            (grad,) = torch.autograd.grad(loss, theta)
            return loss.detach(), grad

        entry = rep.entry(f"fit_step_{method}")
        grads[method] = time_reps(entry.timer, value_and_grad, num_reps,
                                  dev)[1].cpu().numpy()
    gdiff = float(np.abs(grads["pallas"] - grads["xla"]).sum())
    rep.entries["fit_step_xla"].total_error = 0.0
    rep.entries["fit_step_pallas"].total_error = gdiff
    rep.report("fit_step_xla")
    rep.report("fit_step_pallas")


def _run_stage_split(a, b, c, d, num_matrices, n, stream, dev):
    """Un-fused per-stage timing, mirroring the DETAILED_LOGGING build
    (``src/gauss_bench.cu:150-256``): each stage on the host clock, its
    outputs waited for.  Emits ``name,numMatrices,n,ms,ns`` lines
    (``include/timer.h:8-9``)."""
    def dot(x, y):
        return linalg.matmul(x.mT, y)

    def put(x):
        return torch.tensor(x, device=dev)

    # one untimed pass: library handles and the first launches
    dot(put(a), linalg.matmul(linalg.inverse_lu(
        linalg.add_diagonal(put(b), put(c))), put(d))).cpu()

    t = Timer("calculate_mean_gpu_mem_htod")
    t.start()
    b_dev, c_dev, d_dev = put(b), put(c), put(d)
    t.stop(b_dev, c_dev, d_dev)
    t.log(num_matrices, n, stream)

    t = Timer("calculate_mean_gpu_add")
    t.start()
    k = linalg.add_diagonal(b_dev, c_dev)
    t.stop(k)
    t.log(num_matrices, n, stream)

    t = Timer("calculate_mean_gpu_inv")
    t.start()
    k_inv = linalg.inverse_lu(k)
    t.stop(k_inv)
    t.log(num_matrices, n, stream)

    t = Timer("calculate_mean_gpu_mul")
    t.start()
    x = linalg.matmul(k_inv, d_dev)
    t.stop(x)
    t.log(num_matrices, n, stream)

    a_dev = put(a)
    t = Timer("calculate_mean_gpu_dot")
    t.start()
    m = dot(a_dev, x)
    t.stop(m)
    t.log(num_matrices, n, stream)

    t = Timer("calculate_mean_gpu_mem_dtoh")
    t.start()
    m.cpu().numpy()
    t.stop()
    t.log(num_matrices, n, stream)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gauss_bench",
        description="GP mean/variance pipeline benchmark (PyTorch/CUDA "
                    "rebuild of src/gauss_bench.cu)",
    )
    p.add_argument("test_folder")
    p.add_argument("num_reps", type=int)
    p.add_argument("num_duplicates", type=int)
    p.add_argument("-csv", action="store_true", dest="csv")
    p.add_argument("--method", default="solve", choices=list(METHODS),
                   help="solve = the reference's -DGAUSS_SOLVE build; lu = "
                        "its GPU pipeline; pallas = the fused Cholesky "
                        "kernel K5; pallas_ns = the fused Newton-Schulz "
                        "kernel K6")
    p.add_argument("--stages", action="store_true",
                   help="emit the DETAILED_LOGGING per-stage split (un-fused)")
    p.add_argument("--skip-cpu", action="store_true")
    p.add_argument("--dtype", default="float32", choices=["float32", "float64"])
    p.add_argument("--transfers", action="store_true",
                   help="time NumPy in -> pipeline -> NumPy out per rep "
                        "(reference parity) instead of device-resident")
    p.add_argument("--fit", action="store_true",
                   help="also time one hyper-parameter-fit value-and-grad "
                        "step per LML backend (fit_step_xla / "
                        "fit_step_pallas rows; models/gp_fit.py)")
    p.add_argument("--cpu-oracle", default="auto",
                   choices=["auto", "scipy", "native"],
                   help="host rows: native = the C++/LAPACK/OpenMP "
                        "gauss_cpu.c twin; auto = native when built, else "
                        "scipy")
    p.add_argument("--device", default="cuda",
                   help="device of the device rows (default: the card; "
                        "'cpu' runs the kernels' plain versions)")
    return p


def run_argv(argv=None, stream=None) -> BenchReporter:
    """What :func:`main` runs: parse the command line, run the bench
    (its rows printed to ``stream``) and return the reporter, whose
    entries hold each row's timer, error and extra metrics."""
    args = _parser().parse_args(argv)
    return run_bench(
        args.test_folder,
        args.num_reps,
        args.num_duplicates,
        csv=args.csv,
        method=args.method,
        stages=args.stages,
        skip_cpu=args.skip_cpu,
        dtype=np.dtype(args.dtype),
        transfers=args.transfers,
        cpu_oracle=args.cpu_oracle,
        fit=args.fit,
        device=args.device,
        stream=stream,
    )


def main(argv=None) -> int:
    try:
        run_argv(argv)
    except EnsureError as e:
        print(f"gauss_bench: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
