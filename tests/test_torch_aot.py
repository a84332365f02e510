"""The port's AOT artifacts (`upmix_tpu_torch.aot`) on the CPU: the
counterparts of tests/test_aot.py, and the two packages' artifacts side
by side.

Each loaded artifact must equal its live class bit for bit (the same
plan and step), survive a metadata round trip and refuse what it cannot
serve.  On the CPU the plans run their kernels' plain versions; the
card's kernels after a load are chip_smoke.py's phase 26."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from helpers import cpu_child_env, make_stereo, snr_db
from upmix_tpu import aot as jax_aot
from upmix_tpu.config import UpmixConfig as JaxUpmixConfig
from upmix_tpu.oracle import oracle_multiband
from upmix_tpu_torch import aot
from upmix_tpu_torch.cli import main
from upmix_tpu_torch.config import UpmixConfig, config_to_dict
from upmix_tpu_torch.models.offline import Upmixer
from upmix_tpu_torch.models.streaming import CudaStreamPool, StreamingUpmixer

ROOT = Path(__file__).resolve().parent.parent
SR = 16000.0
HW = 256
CPU = {"device": "cpu"}


def small_config(cls=UpmixConfig):
    return cls.make([0.0, 400.0, 1600.0], sr=SR, max_block_size=1024)


def stream_config():
    return UpmixConfig.streaming([0.0, 400.0, 1600.0], sr=SR, hw_block_size=HW)


def equal(got, want):
    return all(torch.equal(g, w) for g, w in zip(got, want))


def tree_to_lists(tree):
    if isinstance(tree, dict):
        return {k: tree_to_lists(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return [tree_to_lists(v) for v in tree]
    return np.asarray(tree).tolist()


def test_config_dict_round_trip():
    cfg = small_config()
    cfg2 = aot.config_from_dict(json.loads(json.dumps(aot.config_to_dict(cfg))))
    assert cfg2 == cfg


def test_offline_artifact_matches_live_upmixer(tmp_path):
    cfg = small_config()
    n = 4096
    path = str(tmp_path / "offline.upmixaot")
    meta = aot.save_offline(path, cfg, n, **CPU)
    assert meta["type"] == "offline" and meta["n_samples"] == n and meta["platforms"] == ["cpu"]
    assert "chunk" not in meta and meta["torch_version"] == torch.__version__

    art = aot.load(path, **CPU)
    assert isinstance(art, aot.AotOffline) and art.config == cfg
    L, R = make_stereo(n, SR, seed=3)
    want = Upmixer(cfg, **CPU).process_np(L, R)
    got = art.process_np(L, R)
    for w, g in zip(want, got):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_offline_artifact_pads_short_inputs_and_records_chunk(tmp_path):
    cfg = small_config()
    n = 4096
    path = str(tmp_path / "offline.upmixaot")
    aot.save_offline(path, cfg, n, **CPU)
    art = aot.load(path, **CPU)
    L, R = make_stereo(3000, SR, seed=4)
    # The live Upmixer with pad_granularity=n runs the same padded program.
    want = Upmixer(cfg, pad_granularity=n, **CPU).process_np(L, R)
    for w, g in zip(want, art.process_np(L, R)):
        assert g.shape == (3000,)
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="frozen at"):
        art.process_np(np.zeros(n + 1), np.zeros(n + 1))
    with pytest.raises(ValueError, match="mismatch"):
        art.process_np(np.zeros(10), np.zeros(11))

    # A chunk is recorded and used: the whole-file program at chunk 0.
    aot.save_offline(path, cfg, n, chunk=0, **CPU)
    art = aot.load(path, **CPU)
    assert art.meta["chunk"] == 0
    L, R = make_stereo(n, SR, seed=5)
    for w, g in zip(Upmixer(cfg, chunk=0, **CPU).process_np(L, R), art.process_np(L, R)):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="chunk"):
        aot.save_offline(path, cfg, n, chunk=-1, **CPU)


def test_stream_step_artifact_matches_live_engine(tmp_path):
    cfg = UpmixConfig.streaming([0.0, 500.0], sr=SR, hw_block_size=HW)
    path = str(tmp_path / "stream.upmixaot")
    meta = aot.save_stream_step(path, cfg, HW, **CPU)
    assert meta["type"] == "stream_step" and meta["hw_block_size"] == HW

    art = aot.load(path, **CPU)
    assert isinstance(art, aot.AotStreamStep) and art.hw_block_size == HW
    live = StreamingUpmixer(cfg, HW, **CPU)
    L, R = make_stereo(12 * HW, SR, seed=5)
    for i in range(12):
        sl = slice(i * HW, (i + 1) * HW)
        assert equal(art.push_block(L[sl], R[sl]), live.push_block(L[sl], R[sl]))
    # The pure step from a fresh state gives the first block again.
    state, out = art.step(art.init_state(), np.stack([L[:HW], R[:HW]]))
    assert out.shape == (3, HW) and int(state["t"]) == 1
    with pytest.raises(ValueError, match=rf"push_block expects two \[{HW}\]"):
        art.push_block(np.zeros(HW - 1), np.zeros(HW - 1))
    with pytest.raises(ValueError, match="step expects"):
        art.step(art.init_state(), np.zeros((2, HW - 1)))


@pytest.mark.parametrize("ola", ["time", "spectral"])
def test_stream_pool_artifact_matches_live(tmp_path, ola):
    S = 8
    cfg = stream_config()
    path = str(tmp_path / "pool.upmixaot")
    meta = aot.save_stream_pool(path, cfg, HW, S, group=8, ola=ola, **CPU)
    assert meta["type"] == "stream_pool" and meta["n_streams"] == S and meta["group"] == 8
    assert (meta["ola"], meta["hops"], meta["layout"]) == (ola, 1, "quarters")

    art = aot.load(path, **CPU)
    live = CudaStreamPool(cfg, HW, S, ola=ola, **CPU)
    assert isinstance(art, CudaStreamPool) and art.warmup_blocks == live.warmup_blocks and art.ola == ola
    rng = np.random.default_rng(9)
    blocks = rng.standard_normal((live.warmup_blocks + 4, S, 2, HW)).astype(np.float32) * 0.3
    for blk in blocks:
        assert equal(art.push_blocks(blk[:, 0], blk[:, 1]), live.push_blocks(blk[:, 0], blk[:, 1]))
    # The live class's state conveniences: a reset and restore round trip
    # leaves the next block unchanged.
    snap = art.snapshot()
    art.reset_streams([0, 3])
    art.restore(snap)
    assert equal(art.push_blocks(blocks[0, :, 0], blocks[0, :, 1]),
                 live.push_blocks(blocks[0, :, 0], blocks[0, :, 1]))


@pytest.mark.parametrize("ola", ["time", "spectral"])
def test_stream_pool_multihop_artifact_matches_live(tmp_path, ola):
    S, T = 8, 4
    cfg = stream_config()
    path = str(tmp_path / "pool_t4.upmixaot")
    assert aot.save_stream_pool(path, cfg, HW, S, ola=ola, hops=T, **CPU)["hops"] == T
    art = aot.load(path, **CPU)
    live = CudaStreamPool(cfg, HW, S, ola=ola, **CPU)
    rng = np.random.default_rng(11)
    for _ in range(3):
        slab = rng.standard_normal((2, S, T * HW)).astype(np.float32) * 0.3
        assert equal(art.push_blocks_multi(slab[0], slab[1]), live.push_blocks_multi(slab[0], slab[1]))
    # A multi-hop artifact has no single-hop program, and no other hops.
    with pytest.raises(ValueError, match="push_blocks_multi"):
        art.push_blocks(np.zeros((S, HW), np.float32), np.zeros((S, HW), np.float32))
    with pytest.raises(ValueError, match="AOT-loaded"):
        art.push_blocks_multi(np.zeros((S, 2 * HW), np.float32), np.zeros((S, 2 * HW), np.float32))
    with pytest.raises(ValueError, match="AOT-loaded"):
        art.make_sustained_runner(4, 2)
    run, fresh = art.make_sustained_runner(2 * T, T)  # the frozen step runs sustained
    blocks = torch.as_tensor(rng.standard_normal((2, 2, S, T * HW)), dtype=torch.float32)
    _, cs = run(fresh(), blocks)
    assert cs.shape == (2, S, T * HW)


def test_stream_pool_single_hop_artifact_rejects_multi(tmp_path):
    path = str(tmp_path / "pool_t1.upmixaot")
    aot.save_stream_pool(path, stream_config(), HW, 8, **CPU)
    art = aot.load(path, **CPU)
    with pytest.raises(ValueError, match="AOT-loaded"):
        art.push_blocks_multi(np.zeros((8, 2 * HW), np.float32), np.zeros((8, 2 * HW), np.float32))
    out = art.push_blocks_multi(np.zeros((8, HW), np.float32), np.zeros((8, HW), np.float32))
    assert out[0].shape == (8, HW)


@pytest.mark.parametrize("ola", ["time", "spectral"])
def test_pool_plan_shape_only_matches_built(tmp_path, ola):
    # The loaded pool (the JAX package's shape-only build) is built from the
    # artifact's config; its plan must be the live pool's field for field
    # and tensor for tensor.
    path = str(tmp_path / "pool.upmixaot")
    aot.save_stream_pool(path, stream_config(), HW, 16, ola=ola, **CPU)
    slim, full = aot.load(path, **CPU).plan, CudaStreamPool(stream_config(), HW, 16, ola=ola, **CPU).plan
    assert (slim.hw, slim.warmup, slim.n_streams, slim.ola) == (full.hw, full.warmup, full.n_streams, full.ola)
    assert len(slim.buckets) == len(full.buckets)
    for sb, fb in zip(slim.buckets, full.buckets):
        assert (sb.block, sb.hop, sb.passes, sb.lo, sb.kept, sb.edge_product) == (
            fb.block, fb.hop, fb.passes, fb.lo, fb.kept, fb.edge_product)
        for name in ("analysis_window", "synthesis_window", "gains", "twiddles"):
            assert torch.equal(getattr(sb, name), getattr(fb, name))
        assert sb.wide is None and sb.edge_weight is None  # CPU plans carry no card-only tables
    if ola == "spectral":  # the routes are worked out from the restored plan
        assert slim.spectral_routes(4).frames == full.spectral_routes(4).frames


@pytest.mark.parametrize("ola", ["time", "spectral"])
def test_aot_pool_restore_after_json_round_trip(tmp_path, ola):
    S = 8
    cfg = stream_config()
    path = str(tmp_path / "pool.upmixaot")
    aot.save_stream_pool(path, cfg, HW, S, ola=ola, **CPU)
    art = aot.load(path, **CPU)
    live = CudaStreamPool(cfg, HW, S, ola=ola, **CPU)
    rng = np.random.default_rng(11)
    blocks = rng.standard_normal((live.warmup_blocks + 3, S, 2, HW)).astype(np.float32)
    for blk in blocks[:-1]:
        live.push_blocks(blk[:, 0], blk[:, 1])
        art.push_blocks(blk[:, 0], blk[:, 1])
    art.restore(json.loads(json.dumps(tree_to_lists(art.snapshot()))))  # tuples -> lists, arrays -> nested lists
    assert equal(art.push_blocks(blocks[-1, :, 0], blocks[-1, :, 1]),
                 live.push_blocks(blocks[-1, :, 0], blocks[-1, :, 1]))


def test_stream_pool_artifact_rejects_ineligible_config(tmp_path):
    # A hop (256 for the 1024 block) that does not divide hw 128: the pool
    # kernel does not take it, as the live pool refuses it.
    cfg = stream_config()
    with pytest.raises(ValueError, match="not eligible"):
        aot.save_stream_pool(str(tmp_path / "x.upmixaot"), cfg, 128, 8, **CPU)
    with pytest.raises(ValueError, match="not eligible"):
        CudaStreamPool(cfg, 128, 8, **CPU)
    with pytest.raises(ValueError, match="unknown ola"):
        aot.save_stream_pool(str(tmp_path / "x.upmixaot"), cfg, HW, 8, ola="freq", **CPU)
    with pytest.raises(ValueError, match="hops"):
        aot.save_stream_pool(str(tmp_path / "x.upmixaot"), cfg, HW, 8, hops=0, **CPU)


def test_read_meta_and_bad_files(tmp_path):
    path = str(tmp_path / "offline.upmixaot")
    aot.save_offline(path, small_config(), 2048, **CPU)
    meta = aot.read_meta(path)
    assert meta["type"] == "offline" and meta["platforms"] == ["cpu"] and len(meta["library_key"]) == 16

    bad = tmp_path / "bad.upmixaot"
    bad.write_bytes(b"not an artifact")
    with pytest.raises(ValueError, match="not an upmix_tpu AOT artifact"):
        aot.load(str(bad))
    with pytest.raises(ValueError, match="not an upmix_tpu AOT artifact"):
        aot.read_meta(str(bad))
    other = tmp_path / "v2.upmixaot"
    other.write_bytes(b"UPMIXAOT1\n" + json.dumps({**meta, "format": 2}).encode() + b"\n")
    with pytest.raises(ValueError, match="unsupported artifact format"):
        aot.read_meta(str(other))


def test_platforms(tmp_path):
    path = str(tmp_path / "cuda.upmixaot")
    assert aot.save_offline(path, small_config(), 2048)["platforms"] == ["cuda"]  # the default device's
    with pytest.raises(ValueError, match="cannot load on cpu"):
        aot.load(path, **CPU)
    assert aot.save_offline(path, small_config(), 2048, platforms=["CUDA", "cpu"])["platforms"] == ["cuda", "cpu"]
    assert isinstance(aot.load(path, **CPU), aot.AotOffline)
    for plats in (["tpu"], []):
        with pytest.raises(ValueError) as exc:
            aot.save_offline(path, small_config(), 2048, platforms=plats)
        assert "\n" not in str(exc.value)


def test_drifted_tables_are_refused(tmp_path):
    # The payload pins the plan's tables: one changed coefficient, and the
    # load refuses instead of serving another program.
    import io

    path = tmp_path / "pool.upmixaot"
    aot.save_stream_pool(str(path), stream_config(), HW, 8, **CPU)
    raw = path.read_bytes()
    head, payload = raw.split(b"\n", 2)[:2], raw.split(b"\n", 2)[2]
    with np.load(io.BytesIO(payload)) as f:
        tables = {k: f[k] for k in f.files}
    tables["0.gains"] = tables["0.gains"].copy()
    tables["0.gains"].flat[5] += 1e-6
    buf = io.BytesIO()
    np.savez(buf, **tables)
    path.write_bytes(b"\n".join(head) + b"\n" + buf.getvalue())
    with pytest.raises(ValueError, match="'0.gains' differs"):
        aot.load(str(path), **CPU)


_FRESH = r"""
import sys
import numpy as np
from upmix_tpu_torch import aot
from upmix_tpu_torch.ops import windows as W
path, vec = sys.argv[1], np.load(sys.argv[2])
name = "test:aot-vec-window"
assert not W.is_known_window(name)
art = aot.load(path, device="cpu")
assert art.config.bands[0].window == name
np.testing.assert_array_equal(W.make_window(name, len(vec)), vec)
x = np.random.default_rng(0).standard_normal((2, 6 * 256)).astype(np.float32)
c = np.concatenate([art.push_block(x[0, i * 256 : (i + 1) * 256], x[1, i * 256 : (i + 1) * 256])[0].numpy()
                    for i in range(6)])
np.save(sys.argv[3], c)
"""


def test_custom_window_artifact_loads_in_a_fresh_process(tmp_path):
    # An artifact built on a registered window vector loads in a process
    # that never registered it and serves the same window.
    from upmix_tpu_torch.ops import windows as W

    name, n = "test:aot-vec-window", 512
    vec = (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)).astype(np.float32) * 0.97
    W.register_window_vector(name, vec, overwrite=True)
    try:
        cfg = UpmixConfig.streaming([0.0, 400.0, 1600.0], sr=SR, hw_block_size=HW, window=name)
        path = str(tmp_path / "win.upmixaot")
        meta = aot.save_stream_step(path, cfg, HW, **CPU)
        assert name in meta["config"]["custom_windows"]
        np.save(tmp_path / "vec.npy", vec)
        r = subprocess.run([sys.executable, "-c", _FRESH, path, str(tmp_path / "vec.npy"), str(tmp_path / "c.npy")],
                           capture_output=True, text=True, env=cpu_child_env(), cwd=ROOT, timeout=300)
        assert r.returncode == 0, r.stderr[-2000:]
        live = StreamingUpmixer(cfg, HW, **CPU)
        x = np.random.default_rng(0).standard_normal((2, 6 * HW)).astype(np.float32)
        want = np.concatenate([live.push_block(x[0, i * HW : (i + 1) * HW], x[1, i * HW : (i + 1) * HW])[0].numpy()
                               for i in range(6)])
        np.testing.assert_array_equal(np.load(tmp_path / "c.npy"), want)
        assert np.abs(want).max() > 0
        # In this process a same-name registration that differs is refused.
        W.register_window_vector(name, vec * 0.5, overwrite=True)
        with pytest.raises(ValueError, match="differ"):
            aot.load(path, **CPU)
    finally:
        W._CUSTOM.pop(name, None)


def test_callable_window_config_round_trips_sampled():
    from upmix_tpu_torch.ops import windows as W

    name = "test:aot-callable-window"

    def tukey_ish(N):
        x = np.linspace(0, 1, N, dtype=np.float64)
        return (np.sin(np.pi * x) ** 1.5).astype(np.float32)

    W.register_window(name, tukey_ish, overwrite=True)
    try:
        cfg = UpmixConfig.make([0.0, 400.0, 1600.0], sr=SR, max_block_size=1024, window=name)
        d = json.loads(json.dumps(aot.config_to_dict(cfg)))
        assert d["custom_windows"][name]["kind"] == "sampled"
        del W._CUSTOM[name]
        assert aot.config_from_dict(d) == cfg
        for bs in sorted({b.block_size for b in cfg.bands}):
            np.testing.assert_array_equal(W.make_window(name, bs), tukey_ish(bs))
    finally:
        W._CUSTOM.pop(name, None)


def test_reads_a_jax_artifact_and_refuses_to_load_it(tmp_path):
    # The container is shared: the port reads the JAX package's metadata,
    # whose config is the port's for the same UpmixConfig, and refuses to
    # load its StableHLO payload with one line.
    path = str(tmp_path / "jax.upmixaot")
    jax_meta = jax_aot.save_offline(path, small_config(JaxUpmixConfig), 2048, kernel="mm")
    meta = aot.read_meta(path)
    assert meta == json.loads(json.dumps(jax_meta)) and "jax_version" in meta
    assert meta["config"] == json.loads(json.dumps(config_to_dict(small_config())))
    assert aot.config_from_dict(meta["config"]) == small_config()
    with pytest.raises(ValueError) as exc:
        aot.load(path, **CPU)
    assert "JAX package artifact" in str(exc.value) and "\n" not in str(exc.value)


def test_offline_artifact_against_the_jax_artifact_and_the_oracle(tmp_path):
    n = 4096
    L, R = make_stereo(n, SR, seed=7)
    jpath, tpath = str(tmp_path / "jax.upmixaot"), str(tmp_path / "torch.upmixaot")
    jax_aot.save_offline(jpath, small_config(JaxUpmixConfig), n, kernel="mm")
    aot.save_offline(tpath, small_config(), n, **CPU)
    ref = jax_aot.load(jpath).process_np(L, R)
    got = aot.load(tpath, **CPU).process_np(L, R)
    oracle = oracle_multiband(L.astype(np.float64), R.astype(np.float64), small_config(JaxUpmixConfig))
    for g, r, o in zip(got, ref, oracle):
        assert snr_db(np.asarray(r), g) > 80.0
        assert snr_db(o, g) >= 60.0


def test_cli_save_aot_all_kinds(tmp_path, capsys):
    common = ["-", "--sr", "8000", "--band-edges", "0,400,1600", "--device", "cpu"]
    kinds = {
        "offline.upmixaot": (["--aot-samples", "4096", "--max-block-size", "512"], aot.AotOffline),
        "step.upmixaot": (["--aot-stream", "--hw-block", "256"], aot.AotStreamStep),
        "pool.upmixaot": (["--aot-pool", "16", "--aot-hops", "4", "--hw-block", "256", "--pool-ola", "spectral"],
                          CudaStreamPool),
    }
    for name, (extra, cls) in kinds.items():
        path = str(tmp_path / name)
        assert main([*common, "--save-aot", path, *extra]) == 0
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert line["saved"] == path and line["platforms"] == ["cpu"] and line["torch_version"] == torch.__version__
        assert isinstance(aot.load(path, **CPU), cls)
    pool = aot.load(str(tmp_path / "pool.upmixaot"), **CPU)
    assert (pool.n_streams, pool.ola, pool._aot_hops) == (16, "spectral", 4)
    out = pool.push_blocks_multi(np.ones((16, 4 * 256)), np.zeros((16, 4 * 256)))
    assert out[0].shape == (16, 4 * 256)
    # The default platform is the default device's, as the JAX CLI's is its backend's.
    path = str(tmp_path / "x.upmixaot")
    assert main(["-", "--save-aot", path, "--sr", "48000", "--aot-pool", "16", "--aot-hops", "4"]) == 0
    assert aot.read_meta(path)["platforms"] == ["cuda"]
    assert main(["-", "--save-aot", path, "--sr", "48000", "--aot-samples", "4096", "--chunk", "0",
                 "--aot-platforms", "cpu"]) == 0
    assert aot.read_meta(path)["chunk"] == 0
