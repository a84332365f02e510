"""The port's package surfaces against the JAX package's: every name
`upmix_tpu` and `upmix_tpu.ops` export (in `__all__`, in `dir()`, or
lazily) is exported by `upmix_tpu_torch` and `upmix_tpu_torch.ops` and
resolves there, apart from the TPU-only names below; and the port's
spectral whole-frame step gives exact zeros for a plan whose every frame
goes to the edge product (its card counterpart is in
tests/test_torch_cuda.py)."""

import inspect

import numpy as np
import torch

import upmix_tpu
import upmix_tpu.ops
import upmix_tpu_torch
import upmix_tpu_torch.ops
from upmix_tpu_torch.config import UpmixConfig
from upmix_tpu_torch.models.streaming import _plan_stream_buckets
from upmix_tpu_torch.ops.pool import plan_from_stream_buckets, spectral_whole, spectral_whole_plain

# The JAX package's names that exist for its TPU only, with the port's
# counterpart: the Pallas serving pool is CudaStreamPool here.
TPU_ONLY = {"PallasStreamPool": "CudaStreamPool"}
# upmix_tpu's lazy surfaces (its module __getattr__).
JAX_LAZY = ("Upmixer", "upmix_offline", "StreamingUpmixer", "BatchStreamingUpmixer", "PallasStreamPool",
            "make_stream_pool", "BatchUpmixer", "ShardedUpmixer", "run_offline", "run_streaming", "run_pipe",
            "run_jobs")


def _public(mod) -> set:
    return {n for n in dir(mod) if not n.startswith("_") and not inspect.ismodule(getattr(mod, n))}


def test_package_exports_match_jax():
    want = set(upmix_tpu.__all__) | _public(upmix_tpu) | set(JAX_LAZY)
    for name in sorted(want):
        name = TPU_ONLY.get(name, name)
        assert name in upmix_tpu_torch.__all__ or name == "__version__", name
        assert name in dir(upmix_tpu_torch), name
        assert getattr(upmix_tpu_torch, name) is not None
    for name in ("chain_bands", "next_power_of_2", "streaming_stft_table", "freq_to_bin",
                 "hp_freq_to_crossover_width", "compute_block_size_for_low_freq"):
        assert getattr(upmix_tpu_torch, name).__module__ == "upmix_tpu_torch.config"
    assert upmix_tpu_torch.next_power_of_2(1000) == upmix_tpu.next_power_of_2(1000) == 1024
    assert upmix_tpu_torch.streaming_stft_table(48000.0, 2048) == upmix_tpu.streaming_stft_table(48000.0, 2048)
    assert callable(upmix_tpu_torch.run_offline) and callable(upmix_tpu_torch.CudaStreamPool)


def test_ops_exports_match_jax():
    assert upmix_tpu_torch.ops.__all__ == upmix_tpu.ops.__all__
    for name in sorted(set(upmix_tpu.ops.__all__) | _public(upmix_tpu.ops)):
        assert name in dir(upmix_tpu_torch.ops), name
        fn = getattr(upmix_tpu_torch.ops, name)
        assert fn.__module__.startswith("upmix_tpu_torch.ops."), (name, fn.__module__)
    # The named windows are the registry's, bit for bit the JAX package's.
    from upmix_tpu_torch.ops import windows

    for name in ("sqrt_hann", "hann", "blackman", "hamming", "rect"):
        fn = getattr(upmix_tpu_torch.ops, f"make_{name}")
        assert windows._WINDOWS[name] is fn
        for n in (16, 257, 1024):
            np.testing.assert_array_equal(fn(n), getattr(upmix_tpu.ops, f"make_{name}")(n))


def test_spectral_whole_of_an_all_edge_plan_is_zeros():
    # The Bela config's 8192 and 4096 records alone: at hops 1 every frame
    # of both buckets is an edge frame, so no whole frame is left.
    cfg = UpmixConfig.streaming([0.0, 500.0, 2000.0, 8000.0], sr=48000.0, hw_block_size=2048)
    records = [r for r in _plan_stream_buckets(cfg, 2048) if r.block_size in (8192, 4096)]
    plan = plan_from_stream_buckets(records, 2048, 4, 3, "cpu", ola="spectral")
    assert [b.block for b in plan.buckets] == [8192, 4096]
    assert all(not whole for _, whole in plan.spectral_routes(1).frames)
    rng = np.random.default_rng(0)
    t = torch.tensor([2, 5, 9], dtype=torch.int32)
    carries = [torch.as_tensor(rng.standard_normal(b.spectral_carry_shape(3)), dtype=torch.float32)
               for b in plan.buckets]
    specs = [torch.as_tensor(rng.standard_normal((3, 3, b.passes, b.kept, 2)), dtype=torch.float32)
             for b in plan.buckets]
    for out in (spectral_whole_plain(carries, specs, t, plan), spectral_whole(carries, specs, t, plan)):
        assert out.shape == (3, 3, 2048) and not out.any()


def test_parallel_exports_match_jax():
    import upmix_tpu.parallel
    import upmix_tpu_torch.parallel

    for name in upmix_tpu.parallel.__all__:
        assert name in upmix_tpu_torch.parallel.__all__, name
        fn = getattr(upmix_tpu_torch.parallel, name)
        assert fn.__module__.startswith("upmix_tpu_torch.parallel."), (name, fn.__module__)
