"""The port's kernel modules against the JAX Pallas kernels.

On the CPU each wrapper runs its kernel's plain PyTorch version; the
Pallas kernels run in interpret mode.  Both sides sum exact x100
integers, so the patch sums are held bit-exact, and the FindValidPoints
walk evaluates the same f32 expressions in the same order, so its masks
are bit-exact too.  The CUDA kernels themselves are checked against these
plain versions on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuslam.match.correlative import find_valid_points as jfvp
from tpuslam.ops.pallas_correlative import (
    patch_sums_pallas,
    patch_sums_stride2,
)
from tpuslam.ops.pallas_fvp import find_valid_points_batch
from tpuslam_torch.ops import _build
from tpuslam_torch.ops import correlative as tops
from tpuslam_torch.ops import fvp as tfvp

# tiny tensors: one intra-op thread, so that parallel test workers do
# not oversubscribe the cores
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _port_patch_sums(grid, ay, ax, ok, s):
    return tops.patch_sums(_t(grid), _t(ay), _t(ax), _t(ok), s).numpy()


def _jax_patch_sums(grid, ay, ax, ok, s):
    # the Pallas kernel's masking contract: dropped points read the zero
    # landing strip at row G
    g = grid.shape[0]
    ay_s = np.where(ok, ay, g).astype(np.int32)
    ax_s = np.where(ok, ax, 0).astype(np.int32)
    return np.asarray(patch_sums_pallas(jnp.asarray(grid), ay_s, ax_s, s))


def test_patch_sums_plain_bit_exact_vs_pallas():
    """test_pallas_correlative.py's fixture: random grid, 20% dropped."""
    rng = np.random.default_rng(0)
    g, s, n_a, b = 64, 7, 5, 40
    grid = rng.integers(0, 101, (g, g)).astype(np.float32) / 100.0
    ay = rng.integers(0, g - s + 1, (n_a, b)).astype(np.int32)
    ax = rng.integers(0, g - s + 1, (n_a, b)).astype(np.int32)
    ok = rng.random((n_a, b)) >= 0.2
    got = _port_patch_sums(grid, ay, ax, ok, s)
    np.testing.assert_array_equal(got, _jax_patch_sums(grid, ay, ax, ok, s))


def test_patch_sums_plain_unaligned_offsets_vs_pallas():
    """Every (row % 16, col % 128) extraction offset class of the TPU
    kernel's aligned windows, plus dropped points."""
    rng = np.random.default_rng(1)
    g, s = 160, 9
    grid = rng.integers(0, 101, (g, g)).astype(np.float32) / 100.0
    ys = np.arange(0, 16, dtype=np.int32)
    xs = (np.arange(16, dtype=np.int32) * 9) % (g - s)
    ay = np.stack([ys, ys + 3, ys + 130])
    ax = np.stack([xs, xs, (xs + 64) % (g - s)])
    ok = np.ones_like(ay, bool)
    ok[1, ::3] = False
    got = _port_patch_sums(grid, ay, ax, ok, s)
    np.testing.assert_array_equal(got, _jax_patch_sums(grid, ay, ax, ok, s))


@pytest.mark.parametrize("s", [3, 5, 33])
def test_patch_sums_plain_production_sides_vs_pallas(s):
    """The main path's patch sides on a small grid (B = 64)."""
    rng = np.random.default_rng(10 + s)
    g, n_a, b = 2 * s + 40, 3, 64
    grid = rng.integers(0, 101, (g, g)).astype(np.float32) / 100.0
    ay = rng.integers(0, g - s + 1, (n_a, b)).astype(np.int32)
    ax = rng.integers(0, g - s + 1, (n_a, b)).astype(np.int32)
    ok = rng.random((n_a, b)) >= 0.1
    got = _port_patch_sums(grid, ay, ax, ok, s)
    np.testing.assert_array_equal(got, _jax_patch_sums(grid, ay, ax, ok, s))


def test_patch_sums_plain_reads_zero_off_grid():
    """Cells outside the grid read zero (the port's contract; the TPU
    callers never send a kept point off the grid)."""
    grid = torch.full((8, 8), 0.5)
    ay = torch.tensor([[-2, 6]], dtype=torch.int32)
    ax = torch.tensor([[0, 6]], dtype=torch.int32)
    ok = torch.ones((1, 2), dtype=torch.bool)
    out = tops.patch_sums(grid, ay, ax, ok, 3)[0]
    want = torch.zeros(3, 3)
    want[2, :] += 50.0  # point 0: rows -2, -1 off the grid
    want[:2, :2] += 50.0  # point 1: rows/cols 8 off the grid
    assert torch.equal(out, want)


def test_patch_sums_stride2_plain_bit_exact_vs_pallas():
    rng = np.random.default_rng(2)
    g, s2, n_a, b = 97, 11, 4, 50
    span = 2 * (s2 - 1) + 1
    grid = rng.integers(0, 101, (g, g)).astype(np.float32) / 100.0
    ay = rng.integers(0, g - span + 1, (n_a, b)).astype(np.int32)
    ax = rng.integers(0, g - span + 1, (n_a, b)).astype(np.int32)
    ok = rng.random((n_a, b)) >= 0.2
    want = np.asarray(
        patch_sums_stride2(jnp.asarray(grid), ay, ax, jnp.asarray(ok), s2)
    )
    got = tops.patch_sums_stride2(_t(grid), _t(ay), _t(ax), _t(ok), s2)
    np.testing.assert_array_equal(got.numpy(), want)
    # and it is the full patch read on the even sublattice
    full = _port_patch_sums(grid, ay, ax, ok, span)[:, ::2, ::2]
    np.testing.assert_array_equal(got.numpy(), full)


def _fvp_fixture(seed, s, b, *, all_invalid_row=False, clusters=False):
    rng = np.random.default_rng(seed)
    th = np.sort(rng.uniform(-np.pi, np.pi, b))
    r = np.abs(rng.normal(3, 2, (s, b))).clip(0.11, 30)
    if clusters:
        r[:] = 0.12  # everything inside the 0.1 m min-distance regime
    pts = np.stack([r * np.cos(th), r * np.sin(th)], -1)
    pts += rng.normal(0, 0.5, (s, 1, 2))
    valid = rng.uniform(size=(s, b)) > 0.3
    if all_invalid_row:
        valid[min(1, s - 1)] = False
    vp = rng.normal(0, 1, 2)
    return (pts.astype(np.float32), valid, vp.astype(np.float32))


@pytest.mark.parametrize(
    "s,b,kw",
    [
        (1, 64, {}),
        (1, 180, {"all_invalid_row": True}),
        (3, 180, {"clusters": True}),
        (5, 1081, {"all_invalid_row": True}),
        (20, 120, {}),
    ],
)
def test_find_valid_points_plain_bit_exact_vs_jax(s, b, kw):
    pts, valid, vp = _fvp_fixture(s * 1000 + b, s, b, **kw)
    jp, jv, jvp = jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(vp)
    want_kernel = np.asarray(find_valid_points_batch(jp, jv, jvp))
    want_serial = np.asarray(
        jax.vmap(lambda p, v: jfvp(p, v, jvp, parallel=False))(jp, jv)
    )
    got = tfvp.find_valid_points(_t(pts), _t(valid), _t(vp)).numpy()
    np.testing.assert_array_equal(got, want_kernel)
    np.testing.assert_array_equal(got, want_serial)


def test_kernel_loader_raises_without_nvcc(monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR / "absent")
    if _build.Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("this machine has a CUDA toolkit at /usr/local/cuda")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load()


def test_wrappers_reject_unsupported_devices():
    grid = torch.zeros((8, 8), device="meta")
    ay = torch.zeros((1, 2), dtype=torch.int32, device="meta")
    ok = torch.ones((1, 2), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tops.patch_sums(grid, ay, ay, ok, 3)
    pts = torch.zeros((1, 2, 2), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfvp.find_valid_points(pts, ok, torch.zeros(2, device="meta"))


def test_launch_counters_stay_zero_on_cpu():
    for d in (tops.LAUNCHES, tfvp.LAUNCHES):
        for k in d:
            d[k] = 0
    pts, valid, vp = _fvp_fixture(3, 4, 50)
    tfvp.find_valid_points(_t(pts), _t(valid), _t(vp))
    grid = torch.rand(40, 40)
    ay = torch.randint(0, 30, (2, 10), dtype=torch.int32)
    ok = torch.ones((2, 10), dtype=torch.bool)
    tops.patch_sums(grid, ay, ay, ok, 5)
    tops.patch_sums_stride2(grid, ay, ay, ok, 3)
    assert tops.LAUNCHES == {"patch_sums": 0, "patch_sums_stride2": 0}
    assert tfvp.LAUNCHES == {"fvp": 0}
