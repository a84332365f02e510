"""The port's omnibus (on the CPU: its plain version) against the JAX
package's Pallas omnibus kernel run in interpret mode.

Both take the same numpy input and the same bucket plans (the JAX
package's own `_plan_buckets` records, carried over by
`plans_from_numpy`).  The JAX kernel multiplies in bf16x3 (about 1e-6
relative error), the port's plain version uses float32 FFTs, so the bar
is 80 dB SNR per output.
"""

from dataclasses import fields

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import snr_db
from upmix_tpu.config import UpmixConfig as JaxUpmixConfig
from upmix_tpu.models.offline import _plan_buckets as jax_plan_buckets
from upmix_tpu.ops.pallas_omnibus import make_omnibus_plan as jax_make_omnibus_plan
from upmix_tpu.ops.pallas_omnibus import omnibus_lcr as jax_omnibus_lcr
from upmix_tpu_torch.models.offline import plans_from_numpy
from upmix_tpu_torch.ops.omnibus import (
    OmnibusBucket,
    check_geometry,
    make_omnibus_plan,
    omnibus_lcr,
    omnibus_lcr_batch,
    omnibus_lcr_batch_plain,
)
from upmix_tpu_torch.utils.tracing import launches

BENCH = ([0.0, 30.0, 120.0, 480.0, 1920.0, 7680.0], dict(sr=44100.0, max_block_size=65536))
SMALL = ([0.0, 400.0, 1600.0], dict(sr=8000.0, max_block_size=512))
GROWN = ([0.0, 2000.0], dict(sr=8000.0, max_block_size=512, overlap=0.5))

# (config, chunk, make_omnibus_plan kwargs of the JAX side, expected JAX sub kinds)
CASES = {
    # all five subs of the main path: two-stage 65536 / 16384 / 4096,
    # direct 1024 / 256
    "bench": (BENCH, 65536, {}, None),
    "small_direct": (SMALL, 2048, {}, {"_DirectSub"}),
    "small_two_stage": (SMALL, 2048, {"direct_weight_limit": 0}, {"_TwoStageBdSub"}),
    # the 512 bucket's hop 256 exceeds tile_cap 128: grown tile, one
    # lookahead view (tests/test_fftmm.py::test_omnibus_grown_tile_parity)
    "grown_tile": (GROWN, 1024, {"tile_cap": 128}, None),
}


@pytest.mark.parametrize("name", list(CASES))
def test_omnibus_matches_jax_interpret(name):
    (edges, kw), chunk, jkw, kinds = CASES[name]
    jplans = jax_plan_buckets(JaxUpmixConfig.make(edges, **kw), chunk)
    jplan, leftover = jax_make_omnibus_plan(jplans, chunk, min_tile=0, **jkw)
    assert leftover == []
    if kinds is not None:
        assert {type(s).__name__ for s in jplan.subs} == kinds
    plan = make_omnibus_plan(plans_from_numpy(jplans, "cpu"), chunk)
    assert plan.halo == jplan.halo
    x = np.random.default_rng(11).standard_normal((2, chunk + plan.halo)).astype(np.float32)
    jmain, jspill = jax_omnibus_lcr(jnp.asarray(x), jplan, interpret=True)
    main, spill = omnibus_lcr(torch.as_tensor(x), plan)
    assert main.shape == (3, chunk) and spill.shape == (3, plan.halo)
    ref = np.concatenate([np.asarray(jmain), np.asarray(jspill)], axis=1)
    got = torch.cat([main, spill], dim=1).numpy()
    for o in range(3):
        assert snr_db(ref[o], got[o]) > 80.0


def test_batch_rows_are_independent_segments():
    cfg = JaxUpmixConfig.make(*SMALL[:1], **SMALL[1])
    plan = make_omnibus_plan(plans_from_numpy(jax_plan_buckets(cfg, 1024), "cpu"), 1024)
    x = torch.as_tensor(np.random.default_rng(1).standard_normal((3, 2, 1024 + plan.halo)),
                        dtype=torch.float32)
    main, spill = omnibus_lcr_batch(x, plan)
    for s in range(3):
        m1, s1 = omnibus_lcr(x[s], plan)
        torch.testing.assert_close(main[s], m1, rtol=0, atol=0)
        torch.testing.assert_close(spill[s], s1, rtol=0, atol=0)


def test_cpu_dispatch_is_the_plain_version():
    cfg = JaxUpmixConfig.make(*SMALL[:1], **SMALL[1])
    plan = make_omnibus_plan(plans_from_numpy(jax_plan_buckets(cfg, 1024), "cpu"), 1024)
    x = torch.randn((2, 2, 1024 + plan.halo), generator=torch.Generator().manual_seed(0))
    before = launches("K1")
    for a, b in zip(omnibus_lcr_batch(x, plan), omnibus_lcr_batch_plain(x, plan)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert launches("K1") == before  # no kernel on the CPU
    # Neither cpu nor cuda: refused, never run somewhere else.
    with pytest.raises(ValueError):
        omnibus_lcr_batch(x.to("meta"), plan)
    with pytest.raises(ValueError):
        omnibus_lcr_batch(x[..., :-1], plan)


def test_plan_orders_buckets_and_drops_dead_ones():
    cfg = JaxUpmixConfig.make(*BENCH[:1], **BENCH[1])
    jplans = jax_plan_buckets(cfg, 4096)
    buckets = plans_from_numpy(jplans, "cpu")
    # The record holds the FFT kernels' tables and no direct-DFT weights; a
    # CPU plan leaves out the 65536 bucket's split (its plain version needs none).
    assert {f.name for f in fields(OmnibusBucket)} == {
        "block", "hop", "lo", "analysis_window", "synthesis_window", "gains", "twiddles", "wide"}
    assert [(b.block, b.wide is None, b.twiddles is None) for b in buckets if b.block > 16384] == [(65536, True, True)]
    assert [b.kept for b in buckets] == [224, 190, 190, 190, 95]
    plan = make_omnibus_plan(list(buckets) + [None], 65536)
    spills = [b.spill for b in plan.buckets]
    assert spills == sorted(spills, reverse=True) and plan.halo == 49152
    assert make_omnibus_plan([None], 65536) is None
    with pytest.raises(ValueError):
        make_omnibus_plan(buckets, 65536 + 64)  # not a multiple of every hop


def test_dead_bucket_is_dropped():
    # A band entirely above Nyquist has all-zero gains: no device record.
    from dataclasses import replace

    from upmix_tpu_torch.models.offline import _BucketPlan
    from upmix_tpu_torch.ops.omnibus import make_bucket

    ones = np.ones(256, np.float32)
    dead = _BucketPlan(256, 64, 1, 256, ones, ones, np.zeros((1, 129), np.float32))
    assert make_bucket(dead, "cpu") is None
    g = np.zeros((1, 129), np.float32)
    g[0, 10:20] = 1.0
    live = make_bucket(replace(dead, gains=g), "cpu")
    assert isinstance(live, OmnibusBucket) and (live.lo, live.kept) == (10, 10)


@pytest.mark.parametrize("block,hop", [(1000, 250), (512, 192), (256, 96)])
def test_unsupported_geometry_raises(block, hop):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        check_geometry(block, hop)
