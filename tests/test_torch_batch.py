"""The port's BatchUpmixer (on the CPU) against the JAX package's
BatchUpmixer and the NumPy oracle.

Bars: > 80 dB against the JAX engine (both float32, FFTs against the
JAX package's default kernel on the CPU; tests/test_torch_offline.py
holds the chunked paths to the same), > 60 dB against the float64 oracle
(the repo's bar).  Sequential and pipelined runs do the same work on the
same rows, so they agree bit for bit.
"""

import numpy as np
import pytest

from helpers import make_stereo, snr_db
from upmix_tpu.config import UpmixConfig as JaxUpmixConfig
from upmix_tpu.models.batch import BatchUpmixer as JaxBatchUpmixer
from upmix_tpu.oracle import oracle_multiband
from upmix_tpu_torch.config import UpmixConfig
from upmix_tpu_torch.models import BatchUpmixer
from upmix_tpu_torch.parallel import make_mesh

EDGES, KW = [0.0, 400.0, 1600.0], dict(sr=8000.0, max_block_size=512)


def _items(lengths, seed0):
    return [np.stack(make_stereo(n, 8000.0, seed=seed0 + i)).astype(np.float32) for i, n in enumerate(lengths)]


def test_matches_jax_batch_upmixer_and_trims():
    items = _items([4096, 3000], 0)
    ref = JaxBatchUpmixer(JaxUpmixConfig.make(EDGES, **KW), n_samples=4096, batch_size=2)
    want = ref.collect(ref.submit(items))
    bu = BatchUpmixer(UpmixConfig.make(EDGES, **KW), n_samples=4096, batch_size=2, device="cpu")
    got = bu.collect(bu.submit(items))
    assert [o.shape for o in got] == [(3, 4096), (3, 3000)]
    for w, g, item in zip(want, got, items):
        assert g.dtype == np.float32
        n = item.shape[-1]
        oracle = oracle_multiband(item[0], item[1], JaxUpmixConfig.make(EDGES, **KW))
        for c in range(3):
            assert snr_db(np.asarray(w[c]), g[c]) > 80.0
            # padded to 4096 inside the batch: compare before the padded tail
            assert snr_db(oracle[c][: n - 512], g[c][: n - 512]) > 60.0


def test_pipeline_matches_sequential_in_order():
    bu = BatchUpmixer(UpmixConfig.make(EDGES, **KW), n_samples=2048, batch_size=2, device="cpu")
    items = _items([2048] * 5, 10)  # 2 full batches + 1 partial
    seq = list(bu.process_files(items))
    piped = list(bu.process_files(iter(items), pipeline=True))
    assert len(seq) == len(piped) == 5
    for a, b in zip(seq, piped):
        np.testing.assert_array_equal(a, b)
    for item, out in zip(items, seq):
        ref = oracle_multiband(item[0], item[1], JaxUpmixConfig.make(EDGES, **KW))
        assert snr_db(ref[0], out[0]) > 60.0


def test_over_batch_and_over_length_raise():
    bu = BatchUpmixer(UpmixConfig.make(EDGES, **KW), n_samples=1024, batch_size=1, device="cpu")
    item = _items([1024], 0)[0]
    with pytest.raises(ValueError, match="batch_size"):
        bu.submit([item, item])
    with pytest.raises(ValueError, match="n_samples"):
        bu.submit(_items([2048], 30))


def test_data_mesh_matches_unsharded():
    cfg = UpmixConfig.make(EDGES, **KW)
    items = _items([2048] * 4, 20)
    plain = BatchUpmixer(cfg, n_samples=2048, batch_size=4, device="cpu")
    mesh = make_mesh({"data": 2}, devices=["cpu"] * 2)
    sharded = BatchUpmixer(cfg, n_samples=2048, batch_size=4, mesh=mesh)
    for a, b in zip(plain.collect(plain.submit(items)), sharded.collect(sharded.submit(items))):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="divide"):
        BatchUpmixer(cfg, n_samples=2048, batch_size=3, mesh=mesh)
