"""The 16-byte tile kernels of csrc/tile_ops.cu (the transpose and the
per-tile max |a|), modelled on the CPU.

The CUDA kernels run only on the card (tests/test_torch_cuda.py and
chip_smoke.py hold them bitwise against their twins there).  This file holds
what they are built from:

- the host's path rule, ``kernels.tile_path`` (the mirror of the source's
  ``transpose_path``, and the max's split, which the launch takes from the
  host), over dtypes, mb, nb, k and base offsets, the shapes chip_smoke
  drives included;
- a numpy model of the vec16 transpose's thread map and shared layout (the
  block and thread counts read from the source): over block sizes and
  ragged edges every input word is read once and every output word written
  once, from the right input word; every 16-byte access is whole and
  aligned; the 16-byte writes into shared memory and the column reads out of
  it are free of bank conflicts (the design's degree, 1); the scalar path's
  32 x 32 map the same way;
- a model of the max's head / body / tail split: every word of a tile is
  covered once, by the lanes and the four-deep body loop the kernel runs,
  for any tile_elems and base offset, and the model's max (sign-cleared
  words, bf16 pairs folded at the end) equals ``genorm_max_tiles_plain``
  word for word on stacks with NaN, +-inf, -0.0 and subnormals
  (``utils.testing.tile_special_stack``);
- ``slate_tpu``'s Pallas transpose and max, interpreted, against the twins
  on those stacks: the transpose bitwise; the max bitwise except on the
  subnormal tiles, which XLA on the CPU flushes to 0 (as the TPU does) and
  the twins, like the kernels, keep.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from slate_tpu.ops import pallas_ops as po
from slate_tpu_torch.ops import _build
from slate_tpu_torch.ops import kernels as tk
from slate_tpu_torch.utils import testing as tt

# the suite runs in several worker processes that share the cores: one
# intra-op thread each (torch defaults to one a core, which oversubscribes them)
torch.set_num_threads(1)

ITEMSIZES = {torch.float32: 4, torch.bfloat16: 2}


def _source():
    with open(os.path.join(_build.CSRC_DIR, "tile_ops.cu")) as f:
        return f.read()


def _const(name):
    m = re.search(r"constexpr (?:int|long long) %s = ([^;,]+)[;,]" % name, _source())
    return m.group(1).strip()


KVEC_ROWS = int(_const("kVecRows"))
KROW_BYTES = int(_const("kRowBytes"))
KVEC_THREADS = int(_const("kVecThreads"))
KTILE = int(_const("kTile"))
KROWS = int(_const("kRows"))
KREDUCE = int(_const("kReduceThreads"))
KIN_FLIGHT = int(_const("kInFlight"))
KCHUNKS = KROW_BYTES // 16


def test_host_constants_mirror_the_source():
    assert (tk.TILE_VEC_ROWS, tk.TILE_VEC_ROW_BYTES, tk.TILE_SCALAR_BLOCK) == (
        KVEC_ROWS, KROW_BYTES, KTILE)
    assert "kTransposeScalar = 0, kTransposeVec16 = 1" in _source()
    assert "kMaxCta = 0, kMaxWarp = 1" in _source()
    assert tk._TILE_PATH_CODES == {"transpose": ("scalar", "vec16"), "genorm_max": ("cta", "warp")}


# ---------------------------------------------------------------------------
# the path rule
# ---------------------------------------------------------------------------

# (kernel, shape, dtype, a offset in bytes, out offset in bytes) -> (name, vec_bytes, ragged)
PATH_CASES = [
    # chip_smoke's full stack: whole blocks everywhere
    ("transpose", (16384, 256, 256), torch.float32, 0, 0, ("vec16", 16, False)),
    ("transpose", (16384, 256, 256), torch.bfloat16, 0, 0, ("vec16", 16, False)),
    ("genorm_max", (16384, 256, 256), torch.float32, 0, 0, ("cta", 16, False)),
    ("genorm_max", (16384, 256, 256), torch.bfloat16, 0, 0, ("cta", 16, False)),
    # TILE_SMALL (9, 100, 300): f32 rows are whole vectors, bf16 rows are not
    ("transpose", (9, 100, 300), torch.float32, 0, 0, ("vec16", 16, True)),
    ("transpose", (9, 100, 300), torch.bfloat16, 0, 0, ("scalar", 2, True)),
    ("genorm_max", (9, 100, 300), torch.bfloat16, 0, 0, ("cta", 16, False)),
    # aligned but ragged against the 64-row block
    ("transpose", (10, 136, 264), torch.float32, 0, 0, ("vec16", 16, True)),
    ("transpose", (10, 136, 264), torch.bfloat16, 0, 0, ("vec16", 16, True)),
    ("genorm_max", (10, 136, 264), torch.bfloat16, 0, 0, ("cta", 16, False)),
    # a[1:] of a contiguous (9, 100, 37) stack: 7,400 B (bf16) / 14,800 B in
    ("transpose", (8, 100, 37), torch.bfloat16, 7400, 0, ("scalar", 2, True)),
    ("transpose", (8, 100, 37), torch.float32, 14800, 0, ("scalar", 4, True)),
    ("genorm_max", (8, 100, 37), torch.bfloat16, 7400, 0, ("warp", 16, True)),
    ("genorm_max", (8, 100, 37), torch.float32, 14800, 0, ("warp", 16, False)),
    # a whole-vector shape at a base one word off 16 bytes, or written off 16 bytes
    ("transpose", (9, 64, 136), torch.bfloat16, 2, 0, ("scalar", 2, True)),
    ("transpose", (9, 64, 136), torch.float32, 4, 0, ("scalar", 4, True)),
    ("transpose", (9, 64, 136), torch.float32, 0, 8, ("scalar", 4, True)),
    ("transpose", (9, 64, 128), torch.bfloat16, 0, 0, ("vec16", 16, False)),
    ("genorm_max", (9, 64, 136), torch.bfloat16, 2, 0, ("cta", 16, True)),
    ("genorm_max", (9, 64, 136), torch.float32, 4, 0, ("cta", 16, True)),
    # k > 65535: two-row tiles take the scalar transpose, eight-row ones vec16
    ("transpose", (70000, 2, 128), torch.bfloat16, 0, 0, ("scalar", 2, True)),
    ("transpose", (70000, 2, 128), torch.float32, 0, 0, ("scalar", 4, True)),
    ("transpose", (66000, 8, 128), torch.bfloat16, 0, 0, ("vec16", 16, True)),
    ("transpose", (66000, 8, 128), torch.float32, 0, 0, ("vec16", 16, True)),
    ("genorm_max", (70000, 2, 128), torch.bfloat16, 0, 0, ("warp", 16, False)),
    ("genorm_max", (70000, 2, 128), torch.float32, 0, 0, ("warp", 16, False)),
    # whole blocks in both dtypes: 64 x 64 bf16, 64 x 32 f32
    ("transpose", (8, 64, 64), torch.bfloat16, 0, 0, ("vec16", 16, False)),
    ("transpose", (8, 64, 32), torch.float32, 0, 0, ("vec16", 16, False)),
    ("transpose", (8, 32, 96), torch.float32, 0, 0, ("vec16", 16, True)),
    ("transpose", (8, 32, 96), torch.bfloat16, 0, 0, ("vec16", 16, True)),
    # the max's split at its threshold: 16 KB a tile
    ("genorm_max", (3, 64, 128), torch.bfloat16, 0, 0, ("cta", 16, False)),
    ("genorm_max", (3, 63, 128), torch.bfloat16, 0, 0, ("warp", 16, False)),
    ("genorm_max", (3, 32, 128), torch.float32, 0, 0, ("cta", 16, False)),
    ("genorm_max", (3, 1, 4095), torch.float32, 0, 0, ("warp", 16, True)),
    ("genorm_max", (1, 1, 1), torch.bfloat16, 6, 0, ("warp", 16, True)),
]


@pytest.mark.parametrize("kernel,shape,dtype,a_off,out_off,want", PATH_CASES)
def test_path_rule(kernel, shape, dtype, a_off, out_off, want):
    base = 1 << 20  # a 16-byte (indeed 512-byte) aligned allocation
    got = tk.tile_path(kernel, shape, ITEMSIZES[dtype], base + a_off, base + out_off)
    assert tuple(got) == want


@pytest.mark.parametrize("dtype", list(ITEMSIZES))
def test_path_rule_sweep(dtype):
    """vec16 exactly when every row of both stacks is whole aligned vectors;
    the max's split by bytes alone; ragged as the blocks and vectors fall."""
    isz = ITEMSIZES[dtype]
    vec = 16 // isz
    cols = KROW_BYTES // isz
    for mb in (1, 2, 7, 8, 16, 63, 64, 65, 100, 128, 136, 256):
        for nb in (1, 4, 8, 37, 64, 128, 136, 264, 300):
            for off in range(0, 16, isz):
                p = tk.tile_path("transpose", (3, mb, nb), isz, 4096 + off, 8192)
                rows_whole = all(((4096 + off) + (r * nb) * isz) % 16 == 0 for r in range(mb))
                outs_whole = all((8192 + (c * mb) * isz) % 16 == 0 for c in range(nb))
                vec_ok = rows_whole and outs_whole and nb % vec == 0 and mb % vec == 0
                assert (p.name == "vec16") == vec_ok
                if vec_ok:
                    assert p.ragged == bool(mb % KVEC_ROWS or nb % cols)
                else:
                    assert p.vec_bytes == isz and p.ragged == bool(mb % KTILE or nb % KTILE)
                m = tk.tile_path("genorm_max", (3, mb, nb), isz, 4096 + off)
                assert m.name == ("cta" if mb * nb * isz >= 16384 else "warp")
                heads = [((4096 + off) + s * mb * nb * isz) % 16 for s in range(4)]
                assert m.ragged == any(heads)


def test_path_rule_refuses_other_kernels():
    with pytest.raises(ValueError, match="no path rule"):
        tk.tile_path("geadd", (8, 128, 128), 4, 0)


def test_cpu_wrappers_take_the_twins():
    a = tt.tile_stack_at((8, 64, 128), torch.bfloat16, 0, 1, device="cpu")
    before = (tk.transpose_tiles.launches, tk.genorm_max_tiles.launches)
    assert tt.tile_bits_equal(tk.transpose_tiles(a), tk.transpose_tiles_plain(a))
    assert tt.tile_max_equal(tk.genorm_max_tiles(a), tk.genorm_max_tiles_plain(a))
    assert (tk.transpose_tiles.launches, tk.genorm_max_tiles.launches) == before


# ---------------------------------------------------------------------------
# the vec16 transpose: thread map and shared layout
# ---------------------------------------------------------------------------


def _swizzled(r, q, vec):
    """swizzled<V>(r, q): the shared chunk holding chunk q of block row r."""
    return r * KCHUNKS + (q ^ ((r // vec) & (KCHUNKS - 1)))


def _store_map(isz, swizzle=True):
    """store_block's reads: per (thread, output vector) the output row c (in
    the block), the first input row, and the shared 4-byte words it reads,
    one per j (bf16: each word carries columns c and c + 1).  ``swizzle``
    False places chunk q of every row at q, for comparison."""
    vec = 16 // isz
    words = KROW_BYTES // 4
    t = np.arange(KVEC_THREADS)
    lane, warp = t % 32, t // 32
    out = []
    if isz == 2:
        rg, cp = lane % 8, lane // 8
        c = 8 * warp + 2 * cp
        q = (warp ^ rg) if swizzle else warp
        addr = np.stack([(rg * vec + j) * words + q * 4 + cp for j in range(vec)], 1)
        out.append((c, rg * vec, addr, 2))  # two output vectors: rows c and c + 1
    else:
        for u in range(2):
            g = warp + 8 * u
            rg, q = 8 * (g % 2) + lane % 8, g // 2
            c = 4 * q + lane // 8
            qs = (q ^ (rg % 8)) if swizzle else q
            addr = np.stack([(rg * vec + j) * words + qs * 4 + lane // 8 for j in range(vec)], 1)
            out.append((c, rg * vec, addr, 1))
    return out


def _conflict_degree(addr):
    """The most distinct 4-byte words one bank serves for a warp's read."""
    worst = 0
    for w in range(0, KVEC_THREADS, 32):
        for j in range(addr.shape[1]):
            a = np.unique(addr[w:w + 32, j])
            worst = max(worst, int(np.bincount(a % 32, minlength=32).max()))
    return worst


@pytest.mark.parametrize("dtype", list(ITEMSIZES))
def test_vec16_shared_layout_is_conflict_free(dtype):
    isz = ITEMSIZES[dtype]
    vec = 16 // isz
    assert KVEC_ROWS * KCHUNKS // KVEC_THREADS == 2
    # 16-byte writes: each quarter warp (8 lanes, one 128-byte phase) fills 8 distinct chunk columns
    for u in range(2):
        i = np.arange(KVEC_THREADS) + KVEC_THREADS * u
        slot = _swizzled(i // KCHUNKS, i % KCHUNKS, vec)
        for q0 in range(0, KVEC_THREADS, 8):
            assert len(set(slot[q0:q0 + 8] % KCHUNKS)) == 8
    for _, _, addr, _ in _store_map(isz):
        assert _conflict_degree(addr) == 1
    # without the swizzle the same reads would be 8-way conflicted
    assert max(_conflict_degree(a) for _, _, a, _ in _store_map(isz, swizzle=False)) == 8


def _model_vec16(mb, nb, isz, k=2):
    """Run the vec16 kernel's map over a (k, mb, nb) stack of word ids:
    returns (times each input word is read, the output stack of ids, times
    each output word is written)."""
    vec = 16 // isz
    cols = KROW_BYTES // isz
    per_chunk = 16 // isz
    src = np.arange(k * mb * nb).reshape(k, mb, nb)
    reads = np.zeros_like(src)
    out = np.full((k, nb, mb), -1)
    writes = np.zeros_like(out)
    bm, bn = -(-mb // KVEC_ROWS), -(-nb // cols)
    t = np.arange(KVEC_THREADS)
    for b in range(k * bm * bn):
        s, rem = divmod(b, bm * bn)
        r0, c0 = (rem // bn) * KVEC_ROWS, (rem % bn) * cols
        shared = np.full((KVEC_ROWS * KCHUNKS, per_chunk), -1)  # word ids a chunk holds
        for u in range(2):
            i = t + KVEC_THREADS * u
            r, c = r0 + i // KCHUNKS, c0 + (i % KCHUNKS) * vec
            for ti in np.nonzero((r < mb) & (c < nb))[0]:
                rr, cc = r[ti], c[ti]
                assert cc + vec <= nb and ((s * mb * nb + rr * nb + cc) * isz) % 16 == 0
                reads[s, rr, cc:cc + vec] += 1
                shared[_swizzled(rr - r0, (cc - c0) // vec, vec)] = src[s, rr, cc:cc + vec]
        words = shared.reshape(-1, 4 // isz) if isz == 2 else shared.reshape(-1, 1)
        for c, rfirst, addr, nvec in _store_map(isz):
            for ti in range(KVEC_THREADS):
                x = words[addr[ti]]  # (vec, 4 / isz): row j's word
                for h in range(nvec):  # bf16: low halves column c, high halves c + 1
                    oc, r = c0 + c[ti] + h, r0 + rfirst[ti]
                    if r < mb and oc < nb:
                        assert r + vec <= mb and ((s * mb * nb + oc * mb + r) * isz) % 16 == 0
                        out[s, oc, r:r + vec] = x[:, h]
                        writes[s, oc, r:r + vec] += 1
    return src, reads, out, writes


VEC16_SHAPES = [(64, 64), (64, 32), (136, 264), (8, 128), (72, 40), (16, 8), (128, 200)]


@pytest.mark.parametrize("mb,nb", VEC16_SHAPES)
@pytest.mark.parametrize("dtype", list(ITEMSIZES))
def test_vec16_map_moves_every_word_once(mb, nb, dtype):
    isz = ITEMSIZES[dtype]
    assert tk.tile_path("transpose", (2, mb, nb), isz, 0, 0).name == "vec16"
    src, reads, out, writes = _model_vec16(mb, nb, isz)
    assert (reads == 1).all() and (writes == 1).all()
    np.testing.assert_array_equal(out, src.transpose(0, 2, 1))


def _model_scalar(mb, nb, k=2):
    """The scalar kernel's 32 x 8 map over a (k, mb, nb) stack of word ids."""
    src = np.arange(k * mb * nb).reshape(k, mb, nb)
    reads = np.zeros_like(src)
    out = np.full((k, nb, mb), -1)
    writes = np.zeros_like(out)
    bm, bn = -(-mb // KTILE), -(-nb // KTILE)
    tx, ty = np.meshgrid(np.arange(KTILE), np.arange(KROWS), indexing="ij")
    tx, ty = tx.ravel(), ty.ravel()
    for b in range(k * bm * bn):
        s, rem = divmod(b, bm * bn)
        r0, c0 = (rem // bn) * KTILE, (rem % bn) * KTILE
        tile = np.full((KTILE, KTILE + 1), -1)
        for i0 in range(0, KTILE, KROWS):
            r, c = r0 + ty + i0, c0 + tx
            ok = (r < mb) & (c < nb)
            tile[(ty + i0)[ok], tx[ok]] = src[s, r[ok], c[ok]]
            np.add.at(reads, (s, r[ok], c[ok]), 1)
        for i0 in range(0, KTILE, KROWS):
            oc, r = c0 + ty + i0, r0 + tx
            ok = (oc < nb) & (r < mb)
            out[s, oc[ok], r[ok]] = tile[tx[ok], (ty + i0)[ok]]
            np.add.at(writes, (s, oc[ok], r[ok]), 1)
    return src, reads, out, writes


@pytest.mark.parametrize("mb,nb", [(100, 300), (100, 37), (2, 128), (33, 31), (1, 1), (64, 136)])
def test_scalar_map_moves_every_word_once(mb, nb):
    src, reads, out, writes = _model_scalar(mb, nb)
    assert (reads == 1).all() and (writes == 1).all()
    np.testing.assert_array_equal(out, src.transpose(0, 2, 1))


# ---------------------------------------------------------------------------
# the max: head / body / tail and the word max
# ---------------------------------------------------------------------------


def _split(start_byte, t_el, isz):
    """tile_max's split of a tile starting at start_byte: (head words,
    16-byte body vectors, tail start)."""
    vec = 16 // isz
    off = (start_byte % 16) // isz
    head = min(vec - off, t_el) if off else 0
    nv = (t_el - head) // vec
    return head, nv, head + nv * vec


def _lane_words(start_byte, t_el, isz, n):
    """The tile words each of n lanes reads, by the kernel's loops: its head
    word, its tail word, then body vectors lane, lane + n, ... four at a
    time while four fit, then one at a time."""
    vec = 16 // isz
    head, nv, tail0 = _split(start_byte, t_el, isz)
    lanes = []
    for lane in range(n):
        got = []
        if lane < head:
            got.append(lane)
        if lane < t_el - tail0:
            got.append(tail0 + lane)
        i = lane
        while i + 3 * n < nv:
            for d in range(4):
                got.extend(range(head + (i + d * n) * vec, head + (i + d * n + 1) * vec))
            i += 4 * n
        while i < nv:
            got.extend(range(head + i * vec, head + (i + 1) * vec))
            i += n
        lanes.append(got)
    return lanes


TILE_ELEMS = [1, 2, 3, 7, 8, 9, 15, 16, 17, 100, 255, 256, 257, 1000, 1024, 4099, 8192, 8200]


@pytest.mark.parametrize("n", [32, KREDUCE])
@pytest.mark.parametrize("dtype", list(ITEMSIZES))
def test_max_split_covers_every_word_once(n, dtype):
    isz = ITEMSIZES[dtype]
    for t_el in TILE_ELEMS:
        for off in range(0, 16, isz):
            for s in range(3):  # tiles of one stack start at base + s tile bytes
                start = off + s * t_el * isz
                lanes = _lane_words(start, t_el, isz, n)
                words = sorted(w for got in lanes for w in got)
                assert words == list(range(t_el)), (t_el, off, s)
                head, nv, tail0 = _split(start, t_el, isz)
                assert head < 16 // isz and t_el - tail0 < 16 // isz
                if nv:
                    assert (start + head * isz) % 16 == 0


def _vmaxu2(m, v):
    """__vmaxu2: the unsigned max of each 16-bit half of two 32-bit words."""
    return (max(m >> 16, v >> 16) << 16) | max(m & 0xFFFF, v & 0xFFFF)


def _model_max(a, combine="step"):
    """tile_max and the kernels' reductions, word for word: per lane four
    accumulators (the head word into the first, the tail word into the
    second, body vectors four at a time, one each, then the rest into the
    first); each step sign-clears a 4-byte word (bf16: two halves, maxed by
    __vmaxu2) and takes the unsigned max; the accumulators combine by the
    same step, the bf16 halves fold, and the lanes' results take their max.
    ``combine="umax"`` combines the packed accumulators by a plain unsigned
    max instead (a mutant: the higher half decides)."""
    k, mb, nb = a.shape
    t_el, isz = mb * nb, a.element_size()
    itype = tt.TILE_WORDS[a.dtype][0]
    flat = a.reshape(-1).view(itype).numpy().view(np.uint16 if isz == 2 else np.uint32)
    if isz == 2:
        def step(m, v):
            return _vmaxu2(m, int(v) & 0x7FFF7FFF)

        def fold(m):
            return max(m & 0xFFFF, m >> 16)
    else:
        def step(m, v):
            return max(m, int(v) & 0x7FFFFFFF)

        def fold(m):
            return m
    n = 256 if tk.tile_path("genorm_max", a.shape, isz, a.data_ptr()).name == "cta" else 32
    out = np.zeros(k, dtype=flat.dtype)
    for s in range(k):
        start = a.data_ptr() + s * t_el * isz
        tile = flat[s * t_el:(s + 1) * t_el]
        head, nv, tail0 = _split(start, t_el, isz)
        body = tile[head:tail0].view(np.uint32).reshape(nv, 4) if nv else np.zeros((0, 4), np.uint32)
        best = 0
        for lane in range(n):
            m = [0, 0, 0, 0]
            if lane < head:
                m[0] = step(m[0], tile[lane])
            if lane < t_el - tail0:
                m[1] = step(m[1], tile[tail0 + lane])
            i = lane
            while i + 3 * n < nv:
                for d in range(4):
                    for word in body[i + d * n]:
                        m[d] = step(m[d], word)
                i += 4 * n
            while i < nv:
                for word in body[i]:
                    m[0] = step(m[0], word)
                i += n
            if combine == "step":
                lane_max = fold(step(step(m[0], m[1]), step(m[2], m[3])))
            else:
                lane_max = fold(max(m))
            best = max(best, lane_max)
        out[s] = best
    return torch.from_numpy(out.view(np.int16 if isz == 2 else np.int32)).view(a.dtype)


SPECIAL_SHAPES = [(8, 8, 128), (9, 37, 129), (8, 1, 3), (10, 100, 37), (8, 64, 136)]


@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("shape", SPECIAL_SHAPES)
@pytest.mark.parametrize("dtype", list(ITEMSIZES))
def test_model_max_is_the_twin_on_special_values(dtype, shape, offset):
    a = tt.tile_special_stack(shape, dtype, offset, seed=sum(shape) + offset, device="cpu")
    got, want = _model_max(a), tk.genorm_max_tiles_plain(a)
    assert tt.tile_max_equal(got, want)
    names = tt.TILE_SPECIAL
    assert bool(torch.isnan(want[names.index("nan_last_lane")]))
    assert bool(torch.isnan(want[names.index("nan_tail")]))
    assert bool(torch.isnan(want[names.index("neg_nan_head")]))
    assert float(want[names.index("pos_inf")]) == float("inf")
    assert float(want[names.index("neg_inf")]) == float("inf")
    zero = want[names.index("neg_zero")]
    assert float(zero) == 0.0 and not bool(torch.signbit(zero))
    tiny = float(want[names.index("neg_zero_and_subnormal")])
    assert tiny == float(torch.finfo(dtype).smallest_normal) * 2.0 ** -tt.TILE_WORDS[dtype][1]


@pytest.mark.parametrize("dtype", list(ITEMSIZES))
def test_model_max_catches_a_dropped_word(dtype):
    """The comparison is sharp: a model that skips the tail (or reads NaN
    as a number) disagrees with the twin on the special stack."""
    a = tt.tile_special_stack((9, 37, 129), dtype, 1, seed=4, device="cpu")
    want = tk.genorm_max_tiles_plain(a)
    dropped = a.clone()
    w = dropped.view(tt.TILE_WORDS[dtype][0]).view(9, -1)
    w[tt.TILE_SPECIAL.index("nan_tail"), -1] = 0
    assert not tt.tile_max_equal(_model_max(dropped), want)
    assert not tt.tile_max_equal(want.nan_to_num(), want)


@pytest.mark.parametrize("shape", [(8, 16, 128), (8, 64, 256)])
def test_model_max_bf16_accumulators_combine_by_halves(shape):
    """bf16 accumulators hold two halves: combined by a plain unsigned max,
    the word with the larger high half wins and a larger low half is lost,
    which random stacks show at once, in the warp and the CTA split."""
    a = tt.tile_stack_at(shape, torch.bfloat16, 0, seed=7, device="cpu")
    want = tk.genorm_max_tiles_plain(a)
    assert tt.tile_max_equal(_model_max(a), want)
    assert not tt.tile_max_equal(_model_max(a, combine="umax"), want)


@pytest.mark.parametrize("dtype", list(ITEMSIZES))
def test_special_stack_against_interpreted_pallas(dtype):
    a = tt.tile_special_stack((8, 8, 128), dtype, 0, seed=3, device="cpu")
    itype = tt.TILE_WORDS[dtype][0]
    npw = np.int16 if dtype == torch.bfloat16 else np.int32
    ja = jnp.asarray(a.view(itype).numpy()).view(jnp.bfloat16 if npw is np.int16 else jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        tj = np.asarray(po.transpose_pallas(ja)).view(npw)
        mj = po.genorm_max_pallas(ja)
    np.testing.assert_array_equal(tk.transpose_tiles_plain(a).view(itype).numpy(), tj)
    mt = tk.genorm_max_tiles_plain(a)
    nt, nj = mt.view(itype).numpy(), np.asarray(mj).view(npw)
    sub = [tt.TILE_SPECIAL.index("subnormal"), tt.TILE_SPECIAL.index("neg_zero_and_subnormal")]
    keep = np.setdiff1d(np.arange(8), sub)
    nan_t = np.isnan(mt.float().numpy())
    nan_j = np.isnan(np.asarray(mj.astype(jnp.float32)))
    np.testing.assert_array_equal(nan_t, nan_j)
    np.testing.assert_array_equal(nt[keep][~nan_t[keep]], nj[keep][~nan_j[keep]])
    assert (nj[sub] == 0).all() and (nt[sub] != 0).all()  # XLA:CPU flushes subnormals
