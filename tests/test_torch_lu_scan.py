"""The port's scanned LU (slate_tpu_torch.linalg.lu.getrf_scan_array) and
the single-chip LU forms on singular and NaN inputs, against
slate_tpu.linalg.lu.

``getrf_scan_array`` is the form the card takes for f64 above n = 8192;
here it runs at nb = 8, so the four buckets hold several steps each, on a
padded square and a wide shape.  Bitwise: perm and info, also on singular
inputs, where the scanned and tournament forms keep a zero-pivot row in
place, and on a NaN column, where the port's 0/1 masks select as XLA's do.
The factors hold to 100 n eps max|A|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slate_tpu.linalg import lu as jlu
from slate_tpu.utils.testing import generate
from slate_tpu_torch.linalg import lu as tlu

# the suite runs in several worker processes that share the cores: one
# intra-op thread each (torch defaults to one a core, which oversubscribes them)
torch.set_num_threads(1)



def _same(jf, tf, a):
    """perm and info bitwise; lu within 100 n eps max|A|."""
    np.testing.assert_array_equal(tf.perm.numpy(), np.asarray(jf.perm))
    assert int(tf.info) == int(jf.info) and tf.info.dtype == torch.int32
    assert tf.lu.shape == jf.lu.shape
    eps = float(np.finfo(a.dtype).eps)
    limit = 100 * min(a.shape) * eps * np.abs(a).max()
    assert np.abs(tf.lu.numpy() - np.asarray(jf.lu)).max() <= limit


@pytest.mark.parametrize("m,n,dtype", [(100, 100, np.float32), (60, 90, np.complex128)])
def test_getrf_scan_matches_jax(m, n, dtype):
    """nb = 8: 13 (8) panel steps over four buckets, the pad rows and columns."""
    a = generate("randn", m, n, dtype=dtype, seed=m)
    _same(jlu.getrf_scan_array(jnp.asarray(a), nb=8),
          tlu.getrf_scan_array(torch.from_numpy(a), nb=8), a)


# ---------------------------------------------------------------------------
# singular inputs: info (and the pivots around the zero column) bitwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("j", [0, 37])
def test_singular_info_matches_jax(j):
    """A zero column j: info j + 1 in every form.  The recursive form
    swaps no row for it; the scanned and tournament forms keep the
    zero-pivot row in place (p = j); the pivots agree bitwise.  Each form
    at the shape of its parity test above (slate_tpu compiles once per
    shape)."""
    forms = [(64, jlu.getrf_array, tlu.getrf_array),
             (100, lambda x: jlu.getrf_scan_array(x, nb=8),
              lambda x: tlu.getrf_scan_array(x, nb=8)),
             (100, lambda x: jlu.getrf_tntpiv_array(x, nb=16),
              lambda x: tlu.getrf_tntpiv_array(x, nb=16))]
    for n, jfun, tfun in forms:
        a = generate("rands", n, dtype=np.float32, seed=9).copy()
        a[:, j] = 0.0
        jf, tf = jfun(jnp.asarray(a)), tfun(torch.from_numpy(a))
        assert int(tf.info) == int(jf.info) == j + 1
        np.testing.assert_array_equal(tf.perm.numpy(), np.asarray(jf.perm))


def test_nan_column_info_matches_jax():
    """A NaN column below row 20: info 21 and the factors' NaN patterns as
    in slate_tpu (whose 0/1 column masks XLA turns into selects, so the
    NaN stays out of the rows and columns the masks drop), in the
    recursive and the no-pivot forms."""
    a = generate("rands", 64, dtype=np.float32, seed=4).copy()
    a[20:, 20] = np.nan
    dominant = a + 64 * np.eye(64, dtype=a.dtype)
    for jfun, tfun, b in ((jlu.getrf_array, tlu.getrf_array, a),
                          (jlu.getrf_nopiv_array, tlu.getrf_nopiv_array, dominant)):
        jf, tf = jfun(jnp.asarray(b)), tfun(torch.from_numpy(b))
        assert int(tf.info) == int(jf.info) == 21
        np.testing.assert_array_equal(tf.perm.numpy(), np.asarray(jf.perm))
        np.testing.assert_array_equal(np.isnan(tf.lu.numpy()), np.isnan(np.asarray(jf.lu)))
