"""The port's sharded offline path on meshes of repeated CPU devices (the
port's counterpart of XLA's virtual host devices), mirroring
tests/test_sharded.py: mesh helpers, sequence geometry, parity with the
NumPy oracle (> 60 dB, the repo's bar), shard-edge windows against the
port's unsharded Upmixer (< 1e-3, the JAX test's bar), batch padding,
the data-only mesh, production geometry, and the JAX ShardedUpmixer with
its Pallas kernels in interpret mode (> 80 dB: bf16x3 products there,
float32 FFTs here, as tests/test_torch_omnibus.py).
"""

import numpy as np
import pytest
import torch

from helpers import make_stereo, snr_db
from upmix_tpu.config import UpmixConfig as JaxUpmixConfig
from upmix_tpu.oracle import oracle_multiband
from upmix_tpu.parallel import ShardedUpmixer as JaxShardedUpmixer
from upmix_tpu.parallel import make_mesh as jax_make_mesh
from upmix_tpu.parallel import sequence_plan as jax_sequence_plan
from upmix_tpu_torch.config import UpmixConfig
from upmix_tpu_torch.models import Upmixer
from upmix_tpu_torch.parallel import ShardedUpmixer, build_sharded_offline_fn, make_mesh, sequence_plan
from upmix_tpu_torch.parallel import sharded
from upmix_tpu_torch.utils.tracing import launches

SMALL = ([0.0, 400.0, 1600.0], dict(sr=8000.0, max_block_size=512))
PROD = ([0.0, 30.0, 120.0, 480.0, 1920.0, 7680.0], dict(sr=44100.0))


def _cfg(spec=SMALL, **kw):
    return UpmixConfig.make(spec[0], **{**spec[1], **kw})


def _jcfg(spec=SMALL, **kw):
    return JaxUpmixConfig.make(spec[0], **{**spec[1], **kw})


def _mesh(axes):
    n = int(np.prod(list(axes.values())))
    return make_mesh(axes, devices=["cpu"] * n)


def _stereo32(n, sr, seed):
    L, R = make_stereo(n, sr, seed=seed)
    return L.astype(np.float32), R.astype(np.float32)


def test_mesh_helpers():
    mesh = make_mesh({"data": 2, "seq": 4}, devices=["cpu"] * 8)
    assert mesh.shape == {"data": 2, "seq": 4}
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    assert make_mesh(devices=["cpu"] * 8).shape == {"seq": 8}
    with pytest.raises(ValueError):
        make_mesh({"seq": 1024}, devices=["cpu"] * 8)
    if torch.cuda.device_count() == 0:
        with pytest.raises(ValueError):  # the default mesh is made of CUDA devices
            make_mesh()
    else:
        assert make_mesh().shape == {"seq": torch.cuda.device_count()}


@pytest.mark.parametrize(
    "spec,kw,n,n_seq",
    [
        (SMALL, {}, 5000, 8),
        (SMALL, {}, 9000, 4),
        (PROD, {}, 2**17, 8),
        (PROD, {}, 1000, 8),
        (SMALL, dict(overlap=0.65), 2**24, 8),  # frame grid of lcm(block, hop)
        (SMALL, dict(overlap=0.65), 100, 8),  # padding blow-up guard
        (([0.0, 1000.0], dict(sr=8000.0, max_block_size=1999, overlap=0.37)), {}, 5000, 2),  # LCM guard
    ],
)
def test_sequence_plan_matches_jax(spec, kw, n, n_seq):
    try:
        want = jax_sequence_plan(_jcfg(spec, **kw), n, n_seq)
    except ValueError as e:
        with pytest.raises(ValueError, match=" ".join(str(e).split()[:4])):
            sequence_plan(_cfg(spec, **kw), n, n_seq)
        return
    got = sequence_plan(_cfg(spec, **kw), n, n_seq)
    assert (got.n_samples, got.n_devices, got.chunk, got.halo, got.n_padded) == (
        want.n_samples, want.n_devices, want.chunk, want.halo, want.n_padded
    )
    assert got.n_padded == got.chunk * n_seq >= n and got.chunk >= got.halo
    for b in _cfg(spec, **kw).bands:
        assert got.chunk % b.hop_size == 0


def test_production_geometry_plan():
    plan = sequence_plan(_cfg(PROD), 2**17, 8)
    assert plan.halo == 65536 - 16384 == 49152
    assert plan.chunk == 65536 >= plan.halo
    assert plan.n_padded == 8 * 65536


@pytest.mark.parametrize("axes", [{"seq": 8}, {"data": 2, "seq": 4}])
def test_sharded_parity_vs_oracle(axes):
    cfg = _cfg()
    su = ShardedUpmixer(cfg, _mesh(axes))
    L, R = _stereo32(5000, cfg.sr, seed=0)
    ref = oracle_multiband(L, R, _jcfg())
    for name, r, g in zip("C Ls Rs".split(), ref, su.process_np(L, R)):
        assert g.shape == r.shape and snr_db(r, g) > 60.0, name


def test_shard_edges_match_the_unsharded_upmixer():
    # Halo correctness: the 8-way sharded result matches the port's
    # unsharded Upmixer at every internal shard edge.
    cfg = _cfg()
    su = ShardedUpmixer(cfg, _mesh({"seq": 8}))
    L, R = _stereo32(9000, cfg.sr, seed=1)
    single = Upmixer(cfg, device="cpu").process_np(L, R)
    plan = sequence_plan(cfg, 9000, 8)
    for r, g in zip(single, su.process_np(L, R)):
        assert snr_db(r, g) > 60.0
        for d in range(1, 8):
            edge = d * plan.chunk
            if edge + 64 > len(r):
                break
            assert np.max(np.abs(r[edge - 64 : edge + 64] - g[edge - 64 : edge + 64])) < 1e-3, d


def test_dp_sp_batch_and_odd_batch_padding():
    cfg = _cfg()
    su = ShardedUpmixer(cfg, _mesh({"data": 2, "seq": 4}))
    pairs = [_stereo32(4000, cfg.sr, seed=s) for s in (2, 3)]
    x = np.stack([np.stack(p) for p in pairs])
    y = su.process_batch(x)
    assert y.shape == (2, 3, 4000)
    one = su.process_batch(x[:1])  # batch of 1 on data = 2: padded, trimmed
    assert one.shape == (1, 3, 4000)
    torch.testing.assert_close(one[0], y[0], rtol=0, atol=1e-6)
    for i, (L, R) in enumerate(pairs):
        ref = oracle_multiband(L, R, _jcfg())
        for c in range(3):
            assert snr_db(ref[c], y[i, c].numpy()) > 60.0


def test_build_sharded_fn_direct_and_validation():
    cfg = _cfg()
    fn, plan = build_sharded_offline_fn(cfg, 4096, _mesh({"seq": 8}), data_axis=None)
    y = fn(torch.zeros((1, 2, plan.n_padded)))
    assert y.shape == (1, 3, plan.n_padded) and bool((y == 0).all())
    with pytest.raises(ValueError):
        fn(torch.zeros((1, 2, plan.n_padded + 1)))
    su = ShardedUpmixer(cfg, _mesh({"seq": 8}))
    with pytest.raises(ValueError):
        su.process_batch(np.zeros((2, 3, 100), np.float32))
    fn2, plan2 = build_sharded_offline_fn(cfg, 4096, _mesh({"data": 2, "seq": 4}))
    with pytest.raises(ValueError, match="multiple of 2"):
        fn2(torch.zeros((3, 2, plan2.n_padded)))


def test_shards_on_one_device_run_as_rows_of_one_call(monkeypatch):
    # On a 2 x 4 mesh of one device, each bucket is one call over all 8
    # shards: one fused call per narrow bucket, one omnibus call over the
    # rest (on a card, one launch each: 3 per omnibus bucket).
    calls = []

    def spy(kernel, name):
        def run(x, plan):
            calls.append((name, x.shape[0]))
            return kernel(x, plan)

        return run

    monkeypatch.setattr(sharded, "fused_bucket_lcr_batch", spy(sharded.fused_bucket_lcr_batch, "K2"))
    monkeypatch.setattr(sharded, "omnibus_lcr_batch", spy(sharded.omnibus_lcr_batch, "K1"))
    cfg = _cfg(PROD)
    su = ShardedUpmixer(cfg, _mesh({"data": 2, "seq": 4}))
    before = launches("K1", "K2")
    x = np.random.default_rng(5).standard_normal((2, 2, 2**17)).astype(np.float32)
    y = su.process_batch(x)
    assert sorted(calls) == [("K1", 8), ("K2", 8), ("K2", 8), ("K2", 8)]
    assert launches("K1", "K2") == before  # plain versions on the CPU
    for b in range(2):
        ref = oracle_multiband(x[b, 0], x[b, 1], _jcfg(PROD))
        for ch in range(3):
            assert snr_db(ref[ch], y[b, ch].numpy()) > 60.0, (b, ch)


def test_data_only_mesh_pure_dp():
    cfg = _cfg()
    su = ShardedUpmixer(cfg, _mesh({"data": 2}))
    pairs = [_stereo32(5000, cfg.sr, seed=s) for s in (3, 4)]
    y = su.process_batch(np.stack([np.stack(p) for p in pairs])).numpy()
    assert y.shape == (2, 3, 5000)
    for i, (L, R) in enumerate(pairs):
        ref = oracle_multiband(L, R, _jcfg())
        for ch, r in enumerate(ref):
            assert snr_db(r, y[i, ch]) > 60.0


@pytest.mark.parametrize("axes", [{"data": 2}, {"seq": 8}])
@pytest.mark.parametrize(
    "spec,kw",
    [
        (SMALL, dict(overlap=0.65)),  # hop does not divide the block
        (([0.0, 1000.0], dict(sr=8000.0, max_block_size=1000)), {}),  # not a power of two
    ],
)
def test_unsupported_geometry_raises(axes, spec, kw):
    # Geometries no kernel takes run as the JAX package runs them: inside
    # each shard on torch.fft (a seq mesh) or through the offline
    # whole-file program (a data-only mesh).  Where the JAX package
    # refuses the geometry (overlap 0.65 on 8 sequence shards pads 5000
    # samples to 65M: sequence_plan's padding guard), the port refuses it
    # too, with a ValueError, not a NotImplementedError.
    cfg, jcfg = _cfg(spec, **kw), _jcfg(spec, **kw)
    L, R = _stereo32(5000, cfg.sr, seed=21)
    try:
        want = JaxShardedUpmixer(jcfg, jax_make_mesh(axes)).process(L, R)
    except ValueError as e:
        with pytest.raises(ValueError, match="sequence sharding would pad"):
            ShardedUpmixer(cfg, _mesh(axes)).process(L, R)
        assert "sequence sharding would pad" in str(e)
        return
    got = ShardedUpmixer(cfg, _mesh(axes)).process_np(L, R)
    for r, w, g in zip(oracle_multiband(L, R, jcfg), want, got):
        assert snr_db(r, g) > 60.0
        assert snr_db(np.asarray(w), g) > 80.0


def test_production_geometry_seq8_parity_vs_oracle():
    cfg = _cfg(PROD)
    su = ShardedUpmixer(cfg, _mesh({"seq": 8}))
    L, R = _stereo32(2**17, cfg.sr, seed=3)
    ref = oracle_multiband(L, R, _jcfg(PROD))
    for name, r, g in zip("C Ls Rs".split(), ref, su.process_np(L, R)):
        assert snr_db(r, g) > 60.0, name


def test_production_geometry_short_input_padding():
    # Input far shorter than 8 x halo: most shards hold padding and the
    # halo spans several shards' worth of signal.
    cfg = _cfg(PROD)
    su = ShardedUpmixer(cfg, _mesh({"seq": 8}))
    L, R = _stereo32(70000, cfg.sr, seed=4)
    ref = oracle_multiband(L, R, _jcfg(PROD))
    for name, r, g in zip("C Ls Rs".split(), ref, su.process_np(L, R)):
        assert snr_db(r, g) > 60.0, name


def test_matches_jax_sharded_with_pallas_kernels():
    cfg = _cfg()
    L, R = _stereo32(5000, cfg.sr, seed=8)
    x = np.stack([np.stack([L, R]), np.stack([R, L])])
    jsu = JaxShardedUpmixer(_jcfg(), jax_make_mesh({"data": 2, "seq": 4}), kernel="mm", use_pallas=True)
    ref = np.asarray(jsu.process_batch(x))
    got = ShardedUpmixer(cfg, _mesh({"data": 2, "seq": 4})).process_batch(x).numpy()
    assert got.shape == ref.shape == (2, 3, 5000)
    for b in range(2):
        for c in range(3):
            assert snr_db(ref[b, c], got[b, c]) > 80.0, (b, c)


def test_silence_gives_zeros():
    su = ShardedUpmixer(_cfg(PROD), _mesh({"data": 2, "seq": 4}))
    y = su.process_batch(np.zeros((2, 2, 70000), np.float32))
    assert bool((y == 0).all())
