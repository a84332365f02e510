"""The port's fused bucket engine (on the CPU: its plain version) against the
JAX package's Pallas fused kernel run in interpret mode, and the routing
that sends a bucket to it.

Both sides take the same numpy input and the JAX package's own bucket
plans.  The JAX kernel multiplies in bf16x3 (about 1e-6 relative error)
and the port's plain version uses float32 FFTs; the bar is 100 dB, the
bar tests/test_fftmm.py holds the JAX kernel to against its XLA fold.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import snr_db
from upmix_tpu.config import UpmixConfig as JaxUpmixConfig
from upmix_tpu.models.offline import _PALLAS_WEIGHT_BYTES
from upmix_tpu.models.offline import _plan_buckets as jax_plan_buckets
from upmix_tpu.ops.dftmm import make_direct_plan as jax_make_direct_plan
from upmix_tpu.ops.pallas_upmix import fused_bucket_lcr_batch as jax_fused_bucket_lcr_batch
from upmix_tpu.ops.pallas_upmix import make_fused_plan as jax_make_fused_plan
from upmix_tpu_torch.config import UpmixConfig
from upmix_tpu_torch.models.offline import _plan_buckets, plans_from_numpy
from upmix_tpu_torch.ops.fused import (
    FUSED_WEIGHT_BYTES,
    fused_bucket_lcr,
    fused_bucket_lcr_batch,
    fused_bucket_lcr_batch_plain,
    takes_fused,
)
from upmix_tpu_torch.ops.omnibus import launch_geometry, make_bucket, make_omnibus_plan, omnibus_lcr_batch_plain
from upmix_tpu_torch.parallel.sharded import _plan_seq_buckets, route_buckets
from upmix_tpu_torch.utils.tracing import launches

# tests/test_fftmm.py::test_pallas_fused_bucket_matches_fold: 8 kHz, max
# block 512, chunk 2048, 512-sample tiles (so n_tiles > 1 and the JAX
# kernel carries its spill across tiles).
SMALL = ([0.0, 400.0, 1600.0], dict(sr=8000.0, max_block_size=512))
CHUNK = 2048
BENCH = ([0.0, 30.0, 120.0, 480.0, 1920.0, 7680.0], dict(sr=44100.0, max_block_size=65536))


def _jax_fused_plan(p, chunk):
    nz = np.nonzero(p.gains.max(axis=0))[0]
    lo, hi = int(nz[0]), int(nz[-1])
    dplan = jax_make_direct_plan(p.block_size, lo, hi, p.analysis_window, p.synthesis_window)
    return jax_make_fused_plan(
        p.block_size, p.hop_size, chunk, dplan.w_fwd, dplan.w_inv, p.gains[:, lo : hi + 1],
        tile_samples=512,
    )


@pytest.mark.parametrize("bucket", [0, 1])
def test_plain_matches_jax_interpret(bucket):
    p = jax_plan_buckets(JaxUpmixConfig.make(SMALL[0], **SMALL[1]), 4096)[bucket]
    fp = _jax_fused_plan(p, CHUNK)
    assert fp.n_tiles > 1
    b = make_bucket(p, "cpu")
    x = np.random.default_rng(bucket).standard_normal((3, 2, CHUNK + b.spill)).astype(np.float32)
    jmain, jspill = jax_fused_bucket_lcr_batch(jnp.asarray(x), fp, interpret=True)
    main, spill = fused_bucket_lcr_batch(torch.as_tensor(x), b)
    assert main.shape == (3, 3, CHUNK) and spill.shape == (3, 3, b.spill)
    for s in range(3):
        for o in range(3):
            assert snr_db(np.asarray(jmain[s, o]), main[s, o].numpy()) > 100.0
            assert snr_db(np.asarray(jspill[s, o]), spill[s, o].numpy()) > 100.0


def test_plain_is_the_one_bucket_omnibus():
    # The same contract as the omnibus over a plan of this one bucket.
    cfg = UpmixConfig.make(SMALL[0], **SMALL[1])
    for b in plans_from_numpy(_plan_seq_buckets(cfg), "cpu"):
        x = torch.randn((3, 2, CHUNK + b.spill), generator=torch.Generator().manual_seed(b.block))
        ref = omnibus_lcr_batch_plain(x, make_omnibus_plan([b], CHUNK))
        for a, r in zip(fused_bucket_lcr_batch_plain(x, b), ref):
            torch.testing.assert_close(a, r, rtol=0, atol=0)


def test_single_segment_is_a_batch_row():
    cfg = UpmixConfig.make(SMALL[0], **SMALL[1])
    b = plans_from_numpy(_plan_seq_buckets(cfg), "cpu")[0]
    x = torch.randn((3, 2, CHUNK + b.spill), generator=torch.Generator().manual_seed(0))
    main, spill = fused_bucket_lcr_batch(x, b)
    m1, s1 = fused_bucket_lcr(x[1], b)
    torch.testing.assert_close(main[1], m1, rtol=0, atol=0)
    torch.testing.assert_close(spill[1], s1, rtol=0, atol=0)


def test_cpu_dispatch_is_the_plain_version_and_shapes_are_checked():
    cfg = UpmixConfig.make(SMALL[0], **SMALL[1])
    b = plans_from_numpy(_plan_seq_buckets(cfg), "cpu")[0]
    x = torch.randn((2, 2, CHUNK + b.spill), generator=torch.Generator().manual_seed(1))
    before = launches("K2")
    for a, r in zip(fused_bucket_lcr_batch(x, b), fused_bucket_lcr_batch_plain(x, b)):
        torch.testing.assert_close(a, r, rtol=0, atol=0)
    assert launches("K2") == before  # no kernel on the CPU
    with pytest.raises(ValueError):  # neither cpu nor cuda: refused
        fused_bucket_lcr_batch(x.to("meta"), b)
    for bad in (x[..., :-1], x[:, :1], x[0]):
        with pytest.raises(ValueError):
            fused_bucket_lcr_batch(bad, b)


def test_routing_on_the_default_config():
    # 4096, 1024 and 256 within the JAX package's fused gate (7 MiB of
    # weights per direction) go to the fused kernel; 65536 and 16384 to
    # the omnibus.
    cfg = UpmixConfig.make(BENCH[0], **BENCH[1])
    buckets = plans_from_numpy(_plan_seq_buckets(cfg), "cpu")
    omni, narrow = route_buckets(buckets, 65536)
    assert [b.block for b in narrow] == [4096, 1024, 256]
    assert [b.block for b in omni.buckets] == [65536, 16384]
    assert [b.kept for b in narrow] == [190, 190, 95]
    for b in buckets:
        assert takes_fused(b) == (b.block * 2 * b.kept * 4 <= FUSED_WEIGHT_BYTES)
    # K2 runs K1's FFT kernels at K1's launch geometry: at the sharded
    # path's 8 rows of a 2^19 chunk on 132 SMs, 2, 4 and 16 frames a pass.
    geos = [launch_geometry(b, 2**19 // b.hop, 8, 132) for b in narrow]
    assert [(g.frames, g.pair) for g in geos] == [(2, False), (4, False), (16, False)]


def test_routing_all_to_one_kernel():
    cfg = UpmixConfig.make(SMALL[0], **SMALL[1])
    omni, narrow = route_buckets(plans_from_numpy(_plan_seq_buckets(cfg), "cpu") + (None,), CHUNK)
    assert omni is None and [b.block for b in narrow] == [512, 256]


# Seeded configs of tests/test_fuzz_configs.py's kind (its sample rates,
# edge draws, windows, crossover, synthesis and rounding modes) within
# the port's chunked domain (power-of-two blocks, overlaps whose hop
# divides the block), with blocks up to 2^16 so both sides of the gate
# are drawn.
FUZZ_SRS = [8000.0, 16000.0, 22050.0, 44100.0, 48000.0, 96000.0, 192000.0]


def _fuzz_params(seed):
    rng = np.random.default_rng(seed)
    sr = FUZZ_SRS[rng.integers(len(FUZZ_SRS))]
    n_edges = int(rng.integers(1, 11))
    lo = 10.0 if rng.random() < 0.3 else 0.0
    edges = sorted([lo] + [float(e) for e in np.exp(rng.uniform(np.log(20.0), np.log(sr / 2), n_edges - 1))])
    return dict(
        band_edges=edges,
        sr=sr,
        overlap=(0.5, 0.75, 0.875, 0.9375)[rng.integers(4)],
        window=("blackman_harris", "sqrt_hann", "hann", "blackman", "hamming", "rect")[rng.integers(6)],
        xover_mode=("raised_cosine", "hard_zero")[rng.integers(2)],
        synthesis=("wola", "analysis")[rng.integers(2)],
        bin_rounding=("python", "cpp")[rng.integers(2)],
        max_block_size=int(2 ** rng.integers(7, 17)),
    )


def test_gate_is_the_jax_gate_over_fuzz_configs():
    # takes_fused admits exactly the live buckets that the JAX package
    # builds a fused plan for (offline.py:397-403: hop | block and B x 2K
    # x 4 <= 7 MiB), over 60 seeded configs; both outcomes are drawn.
    seen = set()
    for seed in range(20261017, 20261017 + 60):
        params = _fuzz_params(seed)
        try:
            jcfg = JaxUpmixConfig.make(**params)
        except ValueError:
            continue
        cfg = UpmixConfig.make(**params)
        jax_gate = {}
        for p in jax_plan_buckets(jcfg, 1):
            nz = np.nonzero(p.gains.max(axis=0))[0]
            if len(nz):
                kept = int(nz[-1]) - int(nz[0]) + 1
                jax_gate[p.block_size] = (p.block_size % p.hop_size == 0
                                          and p.block_size * 2 * kept * 4 <= _PALLAS_WEIGHT_BYTES)
        port = {b.block: takes_fused(b) for b in plans_from_numpy(_plan_buckets(cfg, 1), "cpu")}
        assert port == jax_gate, (seed, params)
        seen |= set(port.values())
    assert seen == {True, False}
