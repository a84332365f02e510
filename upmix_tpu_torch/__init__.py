"""upmix_tpu_torch — the PyTorch/CUDA port of upmix_tpu.

The offline whole-file upmix (one file, a batch of files, or sharded
over a mesh of devices), block streaming and the multi-stream serving
pool run here on PyTorch tensors; the JAX package's Pallas
kernels on these paths are hand-written CUDA kernels for Hopper
(`csrc/*.cu`).  The layout mirrors `upmix_tpu/`
so each module's counterpart is easy to find:

  - config: UpmixConfig / BandSpec / chain_bands / bucket_bands / EPS and
    the sizing helpers, the port's own copy of the JAX package's config
    (standard library only)
  - ops.windows, ops.gains: numpy host plans (copies of the JAX
    package's, pinned to it by tests); ops.dftmm, the direct-DFT weights,
    a pinned copy that no kernel reads; ops.fftplan: the FFT kernels' tables
  - ops.framing, ops.mask: tensor framing / overlap-add and the mask
  - ops.omnibus: the offline kernel's wrapper, its plain version and plan
  - ops.pool: the serving-pool step's wrapper, plain version and plan
  - ops.pool_floor: the pool's floor probe
  - ops.fused: the fused bucket kernel's wrapper, plain version and gate
  - ops._build: nvcc build and ctypes binding of csrc/
  - models.offline: Upmixer / upmix_offline
  - models.batch: BatchUpmixer (many files as rows of one call)
  - parallel.sharded: make_mesh, ShardedUpmixer (data and sequence
    sharding over the devices of one process), build_sharded_offline_fn
    (also over a mesh that spans processes)
  - parallel.distributed, parallel.pod_check: processes that share one
    global mesh on torch.distributed (init_distributed, local_file_shard,
    run_pod_check)
  - models.streaming: StreamingUpmixer, BatchStreamingUpmixer,
    CudaStreamPool, make_stream_pool
  - ops.int8_dot, ops.overhead_probe: the two measurement probes (the
    precision rungs of a chained product; the fixed cost of a launch)
  - app, cli: the offline, streaming, pipe and job-server entry points
    (`python -m upmix_tpu_torch.cli`); io.wav, metrics
  - utils: get_logger, RealtimeMeter, time_fn, profiling traces and the
    kernels' build directory (utils.cache)
  - serve_stream: the multi-client TCP stream server on the serving pool
    (StreamServer, StreamSession, stream_client, fetch_metrics,
    run_stream_server), with checkpoint/resume and metrics
  - aot: deployment artifacts (the offline program, the streaming step
    and the serving pool frozen with their plans' tables; a load runs the
    card's kernels)
  - native: the ctypes loader of the C++ host streaming engine
    (native/libupmix_host.so, `make -C native`)
  - filter_design, visualize, demo: the FIR crossover design, the
    window and comparison plots, and the demo entry point

This package never imports jax or anything of the JAX package: the
machines it runs on need not have them.  Importing it does not import
torch either; the entry points below load on first use.
"""

from upmix_tpu_torch.config import (
    EPS,
    BandSpec,
    UpmixConfig,
    bucket_bands,
    chain_bands,
    compute_block_size_for_low_freq,
    freq_to_bin,
    hp_freq_to_crossover_width,
    next_power_of_2,
    streaming_stft_table,
)

__version__ = "0.2.0"

_MODELS = (
    "Upmixer",
    "upmix_offline",
    "BatchUpmixer",
    "ShardedUpmixer",
    "make_mesh",
    "StreamingUpmixer",
    "BatchStreamingUpmixer",
    "CudaStreamPool",
    "make_stream_pool",
    "mix_stereo_sum",
)

_APP = ("run_offline", "run_streaming", "run_pipe", "run_jobs")

__all__ = [
    "EPS",
    "BandSpec",
    "UpmixConfig",
    "bucket_bands",
    "chain_bands",
    "compute_block_size_for_low_freq",
    "freq_to_bin",
    "hp_freq_to_crossover_width",
    "next_power_of_2",
    "streaming_stft_table",
    "__version__",
    *_MODELS,
    *_APP,
]


def __getattr__(name):
    if name in _MODELS:
        import upmix_tpu_torch.models as _m

        return getattr(_m, name)
    if name in _APP:
        import upmix_tpu_torch.app as _a

        return getattr(_a, name)
    raise AttributeError(f"module 'upmix_tpu_torch' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_MODELS) | set(_APP))
