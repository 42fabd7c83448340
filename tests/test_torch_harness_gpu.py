"""The port's reference harness on the card: both bench CLIs, the
pinned-buffer stream and the autodiff backward through K2.

These tests need an NVIDIA GPU with ``nvcc`` and skip elsewhere.  The
machine with the card has no JAX, and ``tests/conftest.py`` imports it, so
run them there with::

    python -m pytest --noconftest -q tests/test_torch_harness_gpu.py
"""

import io

import numpy as np
import pytest
import torch

from cuda_matrix_inversion_tpu_torch.bench import gauss_bench, inverse_bench
from cuda_matrix_inversion_tpu_torch.bench.reporting import identity_error_inf
from cuda_matrix_inversion_tpu_torch.io.fixtures import (
    generate_all,
    make_spd_batch,
)
from cuda_matrix_inversion_tpu_torch.io.stream import (
    DeviceBatchStream,
    stream_inverse,
)
from cuda_matrix_inversion_tpu_torch.ops import autodiff, cuda_lu
from cuda_matrix_inversion_tpu_torch.ops.registry import (
    get_inverse_algorithm,
    list_inverse_algorithms,
)

pytestmark = pytest.mark.gpu

GATE = 1e-4
# the GP rows: average error per matrix against the fp64 truth
GP_ATOL = 1e-4
# the autodiff gradient against its fp64 closed form, max-norm relative
AUTODIFF_RTOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (hand-written sm_90a kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def tree(cuda, tmp_path):
    generate_all(str(tmp_path), dims=(32,), num=8)
    return tmp_path


def test_inverse_bench_on_the_card(tree, cuda):
    for folder, roster in (("inverse_8_32x32",
                            inverse_bench.DEFAULT_ALGORITHMS),
                           ("square_5_32x32",
                            inverse_bench.GENERAL_ALGORITHMS)):
        buf = io.StringIO()
        rep = inverse_bench.run_argv(
            [str(tree / folder), "2", "1", "-csv", "--algorithms", *roster,
             "--device", str(cuda)], stream=buf)
        want = inverse_bench.resolve_algorithms(
            roster, set(list_inverse_algorithms()))
        assert [line.split()[3] for line in buf.getvalue().splitlines()] \
            == want
        for name in want:
            assert float(rep.entries[name].extra["max ||AA^-1 - I||_inf"]) \
                < GATE, (folder, name)
            assert rep.entries[name].timer.stats.count == 2


@pytest.mark.parametrize("method", gauss_bench.METHODS)
def test_gauss_bench_on_the_card(tree, cuda, method):
    buf = io.StringIO()
    rep = gauss_bench.run_argv(
        [str(tree / "gaussian_8_32x32"), "2", "2", "-csv", "--method",
         method, "--fit", "--stages", "--device", str(cuda)], stream=buf)
    names = ["means_cpu", "variances_cpu", "means_gpu", "variances_gpu",
             "fit_step_xla", "fit_step_pallas"]
    assert list(rep.entries) == names
    for name in names:
        assert rep.entries[name].total_error / 16 < GP_ATOL, name
    stages = [line.split(",")[0] for line in buf.getvalue().splitlines()
              if "," in line]
    assert stages == [f"calculate_mean_gpu_{s}" for s in
                      ("mem_htod", "add", "inv", "mul", "dot", "mem_dtoh")]


@pytest.mark.parametrize("lane", ["lu_pallas", "newton_schulz_spd10_pallas"])
def test_stream_inverse_matches_the_direct_lane(tree, cuda, lane):
    paths = [str(tree / "inverse_8_32x32" / "a.mats")] * 3
    streamed = list(stream_inverse(paths, lane, batch_size=10, device=cuda))
    chunks = list(DeviceBatchStream(paths, 10, device="cpu")._host_batches())
    assert [x.shape[0] for x in streamed] == [10, 10, 4]
    fn = get_inverse_algorithm(lane)
    for x, host in zip(streamed, chunks):
        direct = fn(torch.tensor(host, device=cuda)).cpu()
        assert torch.equal(torch.from_numpy(x), direct)
        assert identity_error_inf(host, x) < GATE


def test_stream_batches_lie_on_the_card_in_order(cuda):
    rng = np.random.default_rng(3)
    arrays = [rng.standard_normal((7, 5, 5)).astype(np.float32)
              for _ in range(5)]
    got = [b for b in DeviceBatchStream(arrays, batch_size=8, prefetch=2,
                                        device=cuda)]
    assert all(b.is_cuda for b in got)
    assert [b.shape[0] for b in got] == [8, 8, 8, 8, 3]
    np.testing.assert_array_equal(
        torch.cat(got).cpu().numpy(), np.concatenate(arrays))


def test_autodiff_through_k2_matches_the_fp64_closed_form(cuda):
    rng = np.random.default_rng(2029)
    a = torch.tensor(make_spd_batch(100, 32, rng), dtype=torch.float32,
                     device=cuda, requires_grad=True)
    g = torch.tensor(rng.standard_normal((100, 32, 32)), dtype=torch.float32,
                     device=cuda)
    before = cuda_lu.lu_inverse_cuda.launches
    x = autodiff.differentiable("lu_pallas")(a)
    (grad,) = torch.autograd.grad((x * g).sum(), a)
    assert cuda_lu.lu_inverse_cuda.launches > before
    inv64 = torch.linalg.inv(a.detach().double())
    ref = -(inv64.mT @ g.double() @ inv64.mT)
    rel = float((grad.double() - ref).abs().max() / ref.abs().max())
    assert rel <= AUTODIFF_RTOL
