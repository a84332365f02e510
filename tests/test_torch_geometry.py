"""Every offline geometry the JAX package accepts, through the port's entry
points on the CPU: hops that do not divide the block (overlaps 0.6, 0.65,
0.9) and blocks that are not powers of two (`max_block_size=3000`).

No kernel takes these buckets in either package (`ops/omnibus.py::
kernel_geometry`): the JAX package runs them on XLA, the port on
torch.fft, routed by the config's geometry when the program is built
(`models/offline.py::kernel_config`).  Each test feeds the same seeded
input to the port, the JAX package on its CPU backend and the float64
NumPy oracle.  Bars: > 60 dB against the oracle (the repo's bar); > 80
dB against the JAX package (both float32; XLA's FFTs or the matmul DFT
there, torch.fft here).

The reference's own traps are pinned: sequence sharding at overlap 0.65
needs chunk units of lcm(block, hop) (it measured 11.7 dB before that
fix, DESIGN.md §10); short inputs at such overlaps must be refused
cleanly, not padded to tens of millions of samples; hop ∤ block needs
gather framing inside each shard.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from helpers import make_stereo, snr_db
from upmix_tpu.cli import main as jax_main
from upmix_tpu.config import UpmixConfig as JaxUpmixConfig
from upmix_tpu.models.offline import build_offline_fn as jax_build_offline_fn
from upmix_tpu.models.offline import upmix_offline as jax_upmix_offline
from upmix_tpu.oracle import oracle_multiband
from upmix_tpu.parallel import ShardedUpmixer as JaxShardedUpmixer
from upmix_tpu.parallel import make_mesh as jax_make_mesh
from upmix_tpu.parallel import sequence_plan as jax_sequence_plan
from upmix_tpu_torch import cli
from upmix_tpu_torch.config import UpmixConfig
from upmix_tpu_torch.io import read_wav, write_wav
from upmix_tpu_torch.models import BatchUpmixer, Upmixer, offline
from upmix_tpu_torch.parallel import ShardedUpmixer, make_mesh, sequence_plan, sharded

SMALL = [0.0, 400.0, 1600.0]
BENCH = [0.0, 30.0, 120.0, 480.0, 1920.0, 7680.0]


def _cfgs(edges=SMALL, **kw):
    kw = {"sr": 8000.0, "max_block_size": 512, **kw}
    return UpmixConfig.make(edges, **kw), JaxUpmixConfig.make(edges, **kw)


def _stereo32(n, sr, seed):
    return tuple(a.astype(np.float32) for a in make_stereo(n, sr, seed=seed))


def _check(got, jcfg, L, R, want=None):
    """> 60 dB against the oracle, > 80 dB against the JAX stems."""
    ref = oracle_multiband(L, R, jcfg)
    for i, (r, g) in enumerate(zip(ref, got)):
        g = np.asarray(g)
        assert g.shape == r.shape and np.all(np.isfinite(g))
        assert snr_db(r, g) > 60.0, f"output {i}: {snr_db(r, g):.1f} dB vs the oracle"
        if want is not None:
            assert snr_db(np.asarray(want[i]), g) > 80.0, f"output {i} vs the JAX package"


@pytest.fixture
def no_kernel(monkeypatch):
    """Fail if the offline path calls the omnibus wrapper (K1's route)."""

    def refuse(*args, **kwargs):
        raise AssertionError("the omnibus route was taken")

    monkeypatch.setattr(offline, "omnibus_lcr_batch", refuse)


@pytest.mark.parametrize("overlap", [0.5, 0.6, 0.65, 0.875, 0.9])
def test_upmixer_other_overlaps(overlap):
    # The cases of tests/test_edge_cases.py:19, against both JAX kernels.
    cfg, jcfg = _cfgs(overlap=overlap)
    L, R = _stereo32(5000, 8000.0, seed=0)
    up = Upmixer(cfg, device="cpu")
    got = up.process_np(L, R)
    divisible = all(b.block_size % b.hop_size == 0 for b in cfg.bands)
    assert up.kernel_path == divisible == offline.kernel_config(cfg)
    for kernel in ("xla", "mm"):
        _check(got, jcfg, L, R, jax_upmix_offline(L, R, jcfg, kernel=kernel))


@pytest.mark.parametrize("edges,xover", [([0.0], "hard_zero"), ([0.0, 400.0], "raised_cosine")])
def test_non_power_of_two_block(edges, xover, no_kernel):
    cfg, jcfg = _cfgs(edges, max_block_size=3000, xover_mode=xover)
    assert cfg.bands[0].block_size == 3000 and not offline.kernel_config(cfg)
    L, R = _stereo32(5000, 8000.0, seed=11)
    up = Upmixer(cfg, device="cpu")
    _check(up.process_np(L, R), jcfg, L, R, jax_upmix_offline(L, R, jcfg, kernel="mm"))
    assert not up.kernel_path and up._buckets is None  # no kernel plan built for a route it will not use


@pytest.mark.parametrize(
    "kw,n",
    [(dict(max_block_size=3000, xover_mode="raised_cosine"), 2**18 + 7), (dict(max_block_size=256, overlap=0.6), 2**18 + 123)],
)
def test_long_input_through_the_default_chunk(kw, n, no_kernel):
    # Longer than the JAX chunk threshold (2^18): the JAX build_offline_fn
    # still routes these to its whole-file program, and so does the port
    # whatever `chunk` says.
    cfg, jcfg = _cfgs([0.0, 400.0], **kw)
    L, R = _stereo32(n, 8000.0, seed=12)
    for chunk in (None, 2**16):
        fn = offline.build_offline_fn(cfg, n, chunk=chunk, device="cpu")
        got = [t.numpy() for t in fn(torch.as_tensor(L), torch.as_tensor(R))]
        _check(got, jcfg, L, R, jax_build_offline_fn(jcfg, n, kernel="mm")(L, R))


def test_kernel_config_still_builds_its_kernel_plan(monkeypatch):
    # A config the kernels take keeps its route: the plan is built and
    # every segment goes through the omnibus wrapper.
    cfg, jcfg = _cfgs()
    assert offline.kernel_config(cfg)
    calls = []
    real = offline.omnibus_lcr_batch
    monkeypatch.setattr(offline, "omnibus_lcr_batch", lambda x, plan: calls.append(x.shape) or real(x, plan))
    L, R = _stereo32(5000, 8000.0, seed=3)
    up = Upmixer(cfg, device="cpu")
    _check(up.process_np(L, R), jcfg, L, R)
    assert up.kernel_path and up._buckets and len(calls) == 1
    # chunk=0 still asks for the whole-file program.
    assert not Upmixer(cfg, device="cpu", chunk=0).kernel_path


def test_batch_upmixer_overlap_065(no_kernel):
    cfg, jcfg = _cfgs(overlap=0.65)
    files = [np.stack(_stereo32(n, 8000.0, seed=40 + n)) for n in (5000, 4100, 3000)]
    bu = BatchUpmixer(cfg, 5000, 2, device="cpu")
    outs = list(bu.process_files(files, pipeline=True))
    up = Upmixer(cfg, device="cpu")
    for f, y in zip(files, outs):
        assert y.shape == (3, f.shape[1])
        _check(y, jcfg, f[0], f[1])
        single = np.stack(up.process_np(f[0], f[1]))
        assert np.abs(single - y).max() < 1e-5


# ShardedUpmixer: overlap 0.65 on blocks of 512 (hop 179: unit 91,648),
# and max_block_size=1000 (blocks 1000 and 256, unit 32,000).
SHARD_CASES = {"overlap_065": dict(overlap=0.65, edges=[0.0, 400.0]), "block_1000": dict(max_block_size=1000)}
MESHES = [{"seq": 4}, {"data": 2, "seq": 2}, {"data": 2}]


@pytest.mark.parametrize("axes", MESHES, ids=lambda a: ",".join(f"{k}{v}" for k, v in a.items()))
@pytest.mark.parametrize("case", list(SHARD_CASES))
def test_sharded_geometry(case, axes):
    kw = dict(SHARD_CASES[case])
    cfg, jcfg = _cfgs(kw.pop("edges", SMALL), **kw)
    assert not offline.kernel_config(cfg)
    n_dev = math.prod(axes.values())
    su = ShardedUpmixer(cfg, make_mesh(axes, devices=["cpu"] * n_dev))
    L, R = _stereo32(6000, 8000.0, seed=50)
    got = su.process_np(L, R)
    want = JaxShardedUpmixer(jcfg, jax_make_mesh(axes)).process(L, R)
    _check(got, jcfg, L, R, want)
    # Shard edges against the unsharded Upmixer (the JAX test's bar).
    single = Upmixer(cfg, device="cpu").process_np(L, R)
    assert max(float(np.abs(a - b).max()) for a, b in zip(single, got)) < 1e-3


def test_sequence_chunk_is_a_multiple_of_lcm_block_hop():
    # The reference's trap (DESIGN.md §10): chunks that were block
    # multiples but not hop multiples put every shard after the first off
    # the frame grid (11.7 dB).  The chunk is a multiple of lcm(B, H) for
    # every bucket, equal to the JAX package's, and the shards hold parity
    # where an edge falls mid-signal.
    cfg, jcfg = _cfgs([0.0, 400.0], overlap=0.65)
    n = 3 * 91648 + 517
    plan = sequence_plan(cfg, n, 4)
    assert dataclasses.asdict(plan) == dataclasses.asdict(jax_sequence_plan(jcfg, n, 4))
    for b in cfg.bands:
        assert plan.chunk % math.lcm(b.block_size, b.hop_size) == 0
    assert plan.chunk % 512 == 0 and (512 * 2) % 179  # a multiple of the block alone would miss the hop
    assert plan.chunk < n  # shard edges inside the signal
    L, R = _stereo32(n, 8000.0, seed=51)
    got = ShardedUpmixer(cfg, make_mesh({"seq": 4}, devices=["cpu"] * 4)).process_np(L, R)
    _check(got, jcfg, L, R)


def test_short_input_at_nondivisible_overlap_refused_cleanly():
    # The reference's trap (round-5 review #1): a 5000-sample clip at
    # overlap 0.65 on 8 shards would pad to 65M samples.  Both packages
    # refuse it with a ValueError at the call; a pathological frame-grid
    # LCM (bench.py's config at 0.65: 1.5e9 samples) is refused when the
    # upmixer is built.
    cfg, jcfg = _cfgs(overlap=0.65)
    L, R = _stereo32(5000, 8000.0, seed=52)
    su = ShardedUpmixer(cfg, make_mesh({"seq": 8}, devices=["cpu"] * 8))
    for fn in (lambda: su.process(L, R), lambda: JaxShardedUpmixer(jcfg, jax_make_mesh({"seq": 8})).process(L, R)):
        with pytest.raises(ValueError, match="sequence sharding would pad"):
            fn()
    bench, jbench = _cfgs(BENCH, sr=44100.0, max_block_size=65536, overlap=0.65)
    for build in (lambda: ShardedUpmixer(bench, make_mesh({"seq": 4}, devices=["cpu"] * 4)),
                  lambda: JaxShardedUpmixer(jbench, jax_make_mesh({"seq": 4}))):
        with pytest.raises(ValueError, match="multiple of every block AND hop"):
            build()
    # The data-only mesh has no shard edges: it runs the same clip.
    dp = ShardedUpmixer(cfg, make_mesh({"data": 2}, devices=["cpu"] * 2)).process_np(L, R)
    _check(dp, jcfg, L, R)


def test_leftover_buckets_use_gather_framing_in_each_shard():
    # hop ∤ block: the shard body frames with a strided gather and folds
    # with the scatter-free overlap-add (sharded._leftover_lcr); the
    # kernel-geometry buckets of the same config keep the kernel route.
    cfg, _ = _cfgs(overlap=0.875)  # blocks 512 / 256: hops 64 / 32 divide
    ok, left = sharded.split_plans(cfg)
    assert [p.block_size for p in ok] == [512, 256] and not left
    cfg, jcfg = _cfgs(overlap=0.65)
    ok, left = sharded.split_plans(cfg)
    assert not ok and [(p.block_size, p.hop_size) for p in left] == [(512, 179), (256, 89)]
    chunk, halo = 4 * 179 * 89, 512 - 179  # a multiple of both hops
    rng = np.random.default_rng(53)
    x = torch.as_tensor(rng.standard_normal((3, 2, chunk + halo)), dtype=torch.float64)
    for p in left:
        got = sharded._leftover_lcr(x, p, chunk)
        # The same bucket by the whole-file program on this shard's input:
        # equal on the frames that start inside the shard.
        F = chunk // p.hop_size
        span = (F - 1) * p.hop_size + p.block_size
        whole = offline._bucket_lcr(
            offline._BucketPlan(p.block_size, p.hop_size, F, span, p.analysis_window, p.synthesis_window, p.gains),
            x[..., :span], span,
        )
        assert got.shape == (3, 3, chunk + p.block_size - p.hop_size)
        torch.testing.assert_close(got, whole, rtol=0, atol=0)


def test_cli_overlap_065(tmp_path, capsys):
    L, R = make_stereo(3000, 8000, seed=54)
    wav = tmp_path / "clip.wav"
    write_wav(wav, np.column_stack([L, R]) * 0.4, 8000)
    args = [str(wav), "--band-edges", "0,400,1600", "--max-block-size", "512", "--overlap", "0.65",
            "--export-mode", "split"]
    assert cli.main([*args, "--out-dir", str(tmp_path / "t"), "--device", "cpu"]) == 0
    got = [ln for ln in capsys.readouterr().out.splitlines() if ln]
    assert jax_main([*args, "--out-dir", str(tmp_path / "j"), "--no-compile-cache"]) == 0
    want = [ln for ln in capsys.readouterr().out.splitlines() if ln]
    assert len(got) == len(want) == 3
    for p, q in zip(got, want):
        assert p.split("/")[-1] == q.split("/")[-1]
        y, r = read_wav(p)[0], read_wav(q)[0]
        for ch in range(2):
            assert snr_db(r[:, ch], y[:, ch]) >= 60.0
