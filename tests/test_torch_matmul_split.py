"""The CPU side of csrc/matmul.cu's tensor-core GEMM: its layout plan, its
three-plane split of f32 values and its six-product sum, against
``slate_tpu``'s ``matmul_pallas``.

The kernel runs only on the card (tests/test_torch_cuda.py and chip_smoke.py
hold it to its twin there).  Here:

- ``ops.kernels.matmul_operand_plan``, the pure function that decides per
  operand whether the core reads it in place through TMA or through the
  pack kernel, and the padded K-major strides it asks for;
- ``utils.testing.bf16_planes``, the plain model of the pack's split
  x = x0 + x1 + x2 (each plane the leading 8 significant bits of what is
  left, rounded toward zero): exact for finite |x| >= 2^-110 up to f32's
  largest value, every plane with x's sign, NaN and +-inf whole in plane 0;
- ``utils.testing.matmul_split6_model``, the plain model of the f32 product
  (per 64-deep k slab the six plane products x0y0 .. x2y0 in the kernel's
  order, slab sums added in k order), against ``slate_tpu``'s Pallas kernel
  run under ``force_tpu_interpret_mode()`` (precision HIGHEST, full f32 on
  the CPU), within ``utils.testing.matmul_pallas_excess``
  (9 sqrt(k) eps32 |A||B| elementwise: the dropped plane products add at
  most 2^-21 |A||B|).  The plane-pair order is read from the source;
- ``utils.testing.matmul_split6_reading``, the check that holds the card's
  f32 form to the six plane products (where the elementwise tolerance
  passes a dropped plane pair and a TF32 product): it passes the model and
  a full f32 product, and fails each dropped second-order pair, a TF32-like
  product and the three-product bf16_3x.
"""

import importlib
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from slate_tpu_torch.ops import _build
from slate_tpu_torch.ops import kernels as tk
from slate_tpu_torch.utils.testing import (
    MATMUL_PLANE_PAIRS,
    MATMUL_SLAB,
    MATMUL_SPLIT6_LIMIT,
    MATMUL_SPLIT6_SECOND,
    bf16_planes,
    matmul_pallas_excess,
    matmul_split6_model,
    matmul_split6_reading,
)

# the suite runs in several worker processes that share the cores: one
# intra-op thread each (torch defaults to one a core, which oversubscribes them)
torch.set_num_threads(1)

# slate_tpu.ops exports the function matmul, which shadows the module
jmm = importlib.import_module("slate_tpu.ops.matmul")

DTYPES = [torch.float32, torch.bfloat16, torch.float16]


def _source():
    with open(os.path.join(_build.CSRC_DIR, "matmul.cu")) as f:
        return f.read()


# ---------------------------------------------------------------------------
# the layout plan
# ---------------------------------------------------------------------------

M, K, N = 300, 520, 1234


def _layouts(dtype):
    """{name: (a, b, a's path, b's path)} for 16-bit operands, a path being
    "k" (in place, k contiguous), "mn" (in place, a row-major B) or "pack";
    f32 always packs.  Operands are views of larger buffers, so offsets show."""
    base_a = torch.zeros((M + 8, K + 8), dtype=dtype)
    base_b = torch.zeros((K + 8, N + 6), dtype=dtype)  # rows of 1240 elements
    base_bt = torch.zeros((N + 8, K + 8), dtype=dtype)
    return {
        "row_major": (base_a[:M, :K], base_b[:K, :N], "k", "mn"),
        "col_major": (torch.zeros((K, M), dtype=dtype).T, base_bt[:N, :K].T, "pack", "k"),
        "offset_view": (base_a[1:M + 1, 8:K + 8], base_b[1:K + 1, :N], "k", "mn"),
        "odd_offset": (base_a[1:M + 1, 3:K + 3], base_bt[1:N + 1, 3:K + 3].T, "pack", "pack"),
        "odd_stride": (torch.zeros((M, K + 3), dtype=dtype)[:, :K],
                       torch.zeros((N, K + 5), dtype=dtype)[:, :K].T, "pack", "pack"),
        "odd_row_bytes": (base_a[:M, :K], torch.zeros((K, N), dtype=dtype), "k", "pack"),
        "strided": (torch.zeros((M, 2 * K), dtype=dtype)[:, ::2],
                    torch.zeros((2 * N, K), dtype=dtype)[::2].T, "pack", "k"),
    }


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layout", ["row_major", "col_major", "offset_view", "odd_offset", "odd_stride",
                                    "odd_row_bytes", "strided"])
@pytest.mark.parametrize("which", ["a", "b"])
def test_matmul_operand_plan(dtype, layout, which):
    a, b, a_path, b_path = _layouts(dtype)[layout]
    t, path = (a, a_path) if which == "a" else (b, b_path)
    plan = tk.matmul_operand_plan(which, t.shape, t.stride(), t.data_ptr(), t.element_size())
    half = dtype != torch.float32
    if not half:
        path = "pack"
    assert (plan.in_place, plan.k_major) == {"k": (True, True), "mn": (True, False),
                                             "pack": (False, True)}[path]
    assert plan.planes == (1 if half else 3)
    rows = t.shape[0] if which == "a" else t.shape[1]
    if path == "k":
        # the core reads the tensor as it lies: k contiguous, the row stride its own
        assert plan.ld == (t.stride(0) if which == "a" else t.stride(1)) and plan.ld % 8 == 0
        assert plan.plane_stride == rows * plan.ld
    elif path == "mn":
        # n contiguous, the stride between k rows its own
        assert plan.ld == t.stride(0) and plan.ld % 8 == 0 and plan.ld >= N
        assert plan.plane_stride == K * plan.ld
    else:
        assert plan.ld == -(-K // 8) * 8  # k rounded up to 16 bytes
        assert plan.plane_stride == rows * plan.ld


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("ptr,shape,strides,want,want_b", [
    (0, (64, 64), (64, 1), "k", "k"),         # aligned, contiguous
    (2, (64, 64), (64, 1), "pack", "pack"),   # base off 16 bytes
    (16, (64, 64), (64, 1), "k", "k"),
    (0, (64, 60), (60, 1), "pack", "pack"),   # row stride of 120 bytes
    (0, (64, 60), (64, 1), "k", "k"),         # padded rows
    (0, (64, 64), (32, 1), "pack", "pack"),   # rows overlap
    (0, (1, 60), (60, 1), "k", "k"),          # one row: its stride is never used
    (0, (64, 1), (8, 5), "k", "k"),           # k = 1: its stride is never used
    (0, (64, 64), (1, 64), "pack", "mn"),     # k strided: B's n contiguous
    (0, (64, 60), (1, 64), "pack", "mn"),
    (0, (64, 60), (1, 60), "pack", "pack"),   # n contiguous, k rows of 120 bytes
    (0, (64, 64), (0, 1), "pack", "pack"),    # broadcast rows
])
def test_matmul_operand_plan_edges(itemsize, ptr, shape, strides, want, want_b):
    """An (r, k) view as A, and its transpose (k, r) as B: a B with k
    contiguous takes the same plan as A; a B with only n contiguous goes in
    place MN-major, which A has no form for."""
    paths = {"k": (True, True), "mn": (True, False), "pack": (False, True)}
    plan = tk.matmul_operand_plan("a", shape, strides, ptr, itemsize)
    plan_b = tk.matmul_operand_plan("b", shape[::-1], strides[::-1], ptr, itemsize)
    if itemsize == 4:
        want = want_b = "pack"
    assert (plan.in_place, plan.k_major) == paths[want]
    assert (plan_b.in_place, plan_b.k_major) == paths[want_b]
    if want_b == want:
        assert plan_b == plan


def test_matmul_operand_plan_refuses_other_names():
    with pytest.raises(ValueError):
        tk.matmul_operand_plan("c", (2, 2), (2, 1), 0, 2)


# ---------------------------------------------------------------------------
# the three-plane split
# ---------------------------------------------------------------------------


def _values(lo, hi, n=200_000, seed=0):
    """Random f32 values of both signs with exponents in [lo, hi], every
    mantissa bit random."""
    rng = np.random.default_rng(seed + lo + 200)
    mant = rng.integers(0, 1 << 23, n, dtype=np.int64)
    exp = rng.integers(lo, hi + 1, n)
    sign = rng.integers(0, 2, n)
    bits = (sign << 31) | ((exp + 127) << 23) | mant
    return torch.from_numpy(bits.astype(np.uint32).view(np.float32).copy())


@pytest.mark.parametrize("lo,hi", [(-110, -100), (-100, -60), (-60, -20), (-20, -1), (0, 20),
                                   (20, 60), (60, 100), (100, 127)])
def test_planes_add_back_exactly(lo, hi):
    x = _values(lo, hi)
    p = bf16_planes(x)
    assert torch.equal(p.to(torch.bfloat16).float(), p)  # each plane is a bf16 value
    assert torch.equal(p[0] + p[1] + p[2], x)  # and they add back to x
    assert torch.equal((p[0] + p[1]) + p[2], x)
    assert bool(torch.isfinite(p).all())  # no plane overflows, up to f32's largest
    assert bool((p * x >= 0).all())  # every plane has x's sign, or is zero
    assert bool((p[1].abs() <= 2.0 ** -7 * x.abs()).all())
    assert bool((p[2].abs() <= 2.0 ** -15 * x.abs()).all())


def test_planes_of_the_extremes():
    big = torch.finfo(torch.float32).max
    x = torch.tensor([big, -big, torch.finfo(torch.float32).tiny, 2.0 ** -110, 1.0, -0.0, 0.0])
    p = bf16_planes(x)
    assert torch.equal(p.sum(0), x) and bool(torch.isfinite(p).all())


def test_planes_below_the_exact_range_lose_low_bits():
    """Under 2^-110 the last plane drops below bf16's subnormal spacing
    (2^-133): the split stays within 2^-133 of x, but is not exact."""
    x = _values(-126, -111, seed=5)
    p = bf16_planes(x)
    err = (p.sum(0).double() - x.double()).abs()
    assert float(err.max()) < 2.0 ** -133
    assert bool((err > 0).any())


def test_planes_of_nan_and_inf():
    x = torch.tensor([float("nan"), float("inf"), -float("inf"),
                      torch.tensor(0x7F800001, dtype=torch.int32).view(torch.float32).item()])
    p = bf16_planes(x)
    assert bool(p[0, 0].isnan()) and bool(p[0, 3].isnan())  # a NaN stays NaN in plane 0
    assert p[0, 1] == float("inf") and p[0, 2] == -float("inf")
    assert torch.equal(p[1:], torch.zeros((2, 4)))


# ---------------------------------------------------------------------------
# the six-product sum
# ---------------------------------------------------------------------------


def test_plane_pairs_follow_the_source():
    src = _source()
    planes = {}
    for side in ("A", "B"):
        body = re.search(r"kPlane%s\[6\] = \{([^}]*)\}" % side, src).group(1)
        planes[side] = [int(v) for v in body.split(",")]
    assert list(zip(planes["A"], planes["B"])) == list(MATMUL_PLANE_PAIRS)
    assert sorted(MATMUL_PLANE_PAIRS) == sorted((i, j) for i in range(3) for j in range(3) if i + j <= 2)
    # each promoted sum covers 64 k, whatever the depth of a stage
    assert int(re.search(r"constexpr int kSlab = (\d+) / KD;", src).group(1)) == MATMUL_SLAB


def _operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((m, k)).astype(np.float32), rng.standard_normal((k, n)).astype(np.float32)


@pytest.mark.parametrize("shape,blocks", [
    ((200, 130, 70), (128, 128, 128)),
    ((300, 257, 129), (512, 512, 512)),
    ((260, 520, 140), (128, 256, 256)),
])
def test_split6_model_matches_the_interpreted_kernel(shape, blocks):
    """The six-product model against slate_tpu's Pallas kernel (HIGHEST) at
    tests/test_torch_matmul.py's shapes, and closer to the f64 product than
    one bf16 pass by orders of magnitude."""
    m, k, n = shape
    a, b = _operands(m, k, n, sum(shape))
    with pltpu.force_tpu_interpret_mode():
        cj = jmm.matmul_pallas(jnp.asarray(a), jnp.asarray(b), *blocks)
    want = torch.from_numpy(np.array(cj))
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    got = matmul_split6_model(at, bt)
    assert matmul_pallas_excess(at, bt, got, want) <= 1.0
    ref = a.astype(np.float64) @ b.astype(np.float64)
    scale = (np.abs(a).astype(np.float64) @ np.abs(b)).max()
    rel = np.abs(got.numpy() - ref).max() / scale
    one_pass = np.abs((at.bfloat16().float() @ bt.bfloat16().float()).numpy() - ref).max() / scale
    assert rel < 4 * np.finfo(np.float32).eps and one_pass > 100 * rel


@pytest.mark.parametrize("k", [1, 63, 64, 65, 200])
def test_split6_model_slabs(k):
    """The model's slab walk covers every k index once (ragged last slab):
    with operands exact in bf16 the lower planes are zero and the model is
    the plain f32 product of each slab, summed in k order."""
    g = torch.Generator().manual_seed(k)
    a = torch.randn((9, k), generator=g).bfloat16().float()
    b = torch.randn((k, 7), generator=g).bfloat16().float()
    want = torch.zeros((9, 7))
    for k0 in range(0, k, MATMUL_SLAB):
        want += a[:, k0:k0 + MATMUL_SLAB] @ b[k0:k0 + MATMUL_SLAB]
    assert torch.equal(matmul_split6_model(a, b), want)


def test_split6_model_inf_meets_zero_lower_planes():
    """The property the card test pins: an inf of one operand meets the other
    operand's zero lower planes, so the model (and the kernel) reads NaN where
    the plain product reads inf; NaN propagates as in the plain product."""
    a = torch.tensor([[float("inf"), 1.0], [float("nan"), 2.0], [1.5, 2.0]])
    b = torch.tensor([[2.0, 1.0 + 2.0 ** -10 + 2.0 ** -20], [3.0, 4.0]])
    got, plain = matmul_split6_model(a, b), a @ b
    assert bool(got[0, 0].isnan()) and plain[0, 0] == float("inf")  # 2.0: zero lower planes
    assert got[0, 1] == float("inf")  # 1 + 2^-10 + 2^-20: three nonzero planes
    assert torch.equal(got[1].isnan(), plain[1].isnan())
    assert torch.equal(got[2], plain[2])


# ---------------------------------------------------------------------------
# the split6 reading: the f32 form held to the products it sums
# ---------------------------------------------------------------------------

SPLIT6_SHAPES = [(17, 3, 5), (40, 64, 24), (33, 256, 65), (64, 777, 48), (24, 4096, 16)]


def _split6_operands(shape):
    a, b = _operands(*shape, seed=7 * sum(shape))
    return torch.from_numpy(a), torch.from_numpy(b)


@pytest.mark.parametrize("shape", SPLIT6_SHAPES)
def test_split6_reading_passes_the_model_and_a_full_f32_product(shape):
    """Sound products read well inside the limit: the six-product model in
    f32 (the kernel's sum, rounded its own way) and the plain f32 product
    (all nine plane products, another order)."""
    a, b = _split6_operands(shape)
    assert matmul_split6_reading(a, b, matmul_split6_model(a, b))[0] <= MATMUL_SPLIT6_LIMIT / 4
    assert matmul_split6_reading(a, b, a @ b)[0] <= MATMUL_SPLIT6_LIMIT / 4


@pytest.mark.parametrize("pair", MATMUL_SPLIT6_SECOND)
@pytest.mark.parametrize("shape", SPLIT6_SHAPES)
def test_split6_reading_fails_a_dropped_plane_pair(shape, pair):
    """A product that leaves out one second-order plane pair reads above the
    limit (near 1 by construction), as the reading's own planted fault of
    that pair does; from k = 64 on, the elementwise twin tolerance (which
    grows as sqrt(k)) passes it."""
    a, b = _split6_operands(shape)
    pa, pb = bf16_planes(a), bf16_planes(b)
    model = matmul_split6_model(a, b)
    dropped = model - pa[pair[0]] @ pb[pair[1]]
    assert matmul_split6_reading(a, b, dropped)[0] > MATMUL_SPLIT6_LIMIT
    assert matmul_split6_reading(a, b, model)[1]["x%dy%d" % pair] > MATMUL_SPLIT6_LIMIT
    assert (matmul_pallas_excess(a, b, dropped, a @ b) <= 1.0) == (shape[1] >= 64)


def _tf32_cut(x):
    return (x.view(torch.int32) & torch.tensor(-8192, dtype=torch.int32)).view(torch.float32)


@pytest.mark.parametrize("shape", SPLIT6_SHAPES)
def test_split6_reading_fails_tf32_and_bf16x3(shape):
    """A TF32-like product (operands cut to 10 mantissa bits) and bf16_3x
    (x0y0, x0y1, x1y0 only) read far above the limit."""
    a, b = _split6_operands(shape)
    pa, pb = bf16_planes(a), bf16_planes(b)
    assert matmul_split6_reading(a, b, _tf32_cut(a) @ _tf32_cut(b))[0] > 20 * MATMUL_SPLIT6_LIMIT
    three = pa[0] @ pb[0] + pa[0] @ pb[1] + pa[1] @ pb[0]
    assert matmul_split6_reading(a, b, three)[0] > 2 * MATMUL_SPLIT6_LIMIT


def test_split6_reading_works_by_row_blocks():
    """The reading of a product is the same whatever rows a block takes."""
    a, b = _split6_operands((70, 300, 30))
    got = a @ b
    whole = matmul_split6_reading(a, b, got)
    assert matmul_split6_reading(a, b, got, rows=16) == whole


def test_split6_model_in_f64_is_the_exact_six_product_sum():
    a, b = _split6_operands((20, 130, 12))
    pa, pb = bf16_planes(a).double(), bf16_planes(b).double()
    want = sum(pa[i] @ pb[j] for i, j in MATMUL_PLANE_PAIRS)
    got = matmul_split6_model(a, b, torch.float64)
    assert got.dtype == torch.float64
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())
