"""The port's copies of the capture substrate write the same bytes as
``repro.data`` for the same (scale, n, seed, fmt), and read them back."""
import numpy as np
import pytest

from repro.data import pcaplite as jax_pcaplite
from repro.data import plq as jax_plq
from repro.data import rmat as jax_rmat
from repro_torch.data import pcaplite, plq, rmat


@pytest.mark.parametrize("scale,n,seed", [(8, 300, 0), (12, 5000, 7)])
def test_synthetic_packets_identical(scale, n, seed):
    got = rmat.synthetic_packets(n, scale=scale, seed=seed)
    want = jax_rmat.synthetic_packets(n, scale=scale, seed=seed)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("fmt", ["plq", "pcaplite"])
@pytest.mark.parametrize("scale,n,seed", [(8, 300, 0), (12, 5000, 7)])
def test_captures_byte_identical(tmp_path, fmt, scale, n, seed):
    cols = rmat.synthetic_packets(n, scale=scale, seed=seed)
    mine, theirs = tmp_path / f"port.{fmt}", tmp_path / f"ref.{fmt}"
    if fmt == "plq":
        plq.write_plq(str(mine), cols, row_group_size=1024)
        jax_plq.write_plq(str(theirs), jax_rmat.synthetic_packets(
            n, scale=scale, seed=seed), row_group_size=1024)
        back = plq.read_plq(str(mine), ["ts", "src", "dst"])
        assert plq.plq_info(str(mine)) == jax_plq.plq_info(str(theirs))
    else:
        pcaplite.write_pcaplite(str(mine), cols)
        jax_pcaplite.write_pcaplite(str(theirs), jax_rmat.synthetic_packets(
            n, scale=scale, seed=seed))
        back = pcaplite.parse_fast(str(mine))
    assert mine.read_bytes() == theirs.read_bytes()
    for k in ("ts", "src", "dst"):
        np.testing.assert_array_equal(back[k], cols[k])
