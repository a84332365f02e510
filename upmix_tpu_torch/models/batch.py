"""Batched multi-file offline processing with pipelined host I/O.

Port of `upmix_tpu/models/batch.py`.  Many stereo files are stacked into
one [batch, 2, n] tensor and run as rows of one chunked offline call
(`models/offline.py::build_offline_rows_fn`: every row's segments in one
omnibus launch per kernel and bucket), or, with a mesh, split over its
``data`` axis (`parallel/sharded.py`).

On a CUDA device `submit` does not wait for the card: the batch is
uploaded from pinned host memory with `non_blocking`, the result is
copied back into pinned host memory the same way, and only `collect`
waits for that copy.  So with `process_files(pipeline=True)` the host
prepares the next batch while the card computes the current one.
"""

from __future__ import annotations

import numpy as np
import torch

from upmix_tpu_torch.config import UpmixConfig
from upmix_tpu_torch.models.offline import build_offline_rows_fn


class BatchUpmixer:
    """Fixed-geometry batch engine: [batch, 2, n] -> [batch, 3, n].

    Lengths are padded to `n_samples`; batches are padded to `batch_size`
    (both fixed at construction so one program serves the whole run).
    For data parallelism over several devices pass a mesh
    (`parallel.make_mesh`): the batch axis is split over its 'data' axis,
    and the mesh's devices decide where the work runs.
    """

    def __init__(self, config: UpmixConfig, n_samples: int, batch_size: int, mesh=None, device="cuda"):
        self.config = config
        self.n_samples = int(n_samples)
        self.batch_size = int(batch_size)
        self.mesh = mesh
        if mesh is not None:
            from upmix_tpu_torch.parallel.sharded import build_sharded_offline_fn

            d = mesh.shape.get("data", 1)
            if self.batch_size % d:
                raise ValueError(f"batch_size {self.batch_size} must divide over the mesh's data axis ({d})")
            self._fn, _ = build_sharded_offline_fn(config, self.n_samples, mesh, seq_axis=None)
            self.device = mesh.devices.flat[0]
        else:
            self.device = torch.device(device)
            self._fn = build_offline_rows_fn(config, self.n_samples, device=self.device)

    def _prep(self, arrays):
        """Stack a list of [2, n_i] float arrays into the fixed geometry."""
        pinned = self.device.type == "cuda"
        x = torch.zeros((self.batch_size, 2, self.n_samples), dtype=torch.float32, pin_memory=pinned)
        lengths = []
        for i, a in enumerate(arrays):
            if i >= self.batch_size:
                raise ValueError(f"got more than batch_size={self.batch_size} items")
            n = a.shape[-1]
            if n > self.n_samples:
                raise ValueError(
                    f"item {i} has {n} samples > n_samples={self.n_samples}; "
                    f"split long inputs or build a larger-geometry engine"
                )
            x[i, :, :n] = torch.as_tensor(np.asarray(a, np.float32))
            lengths.append(n)
        return x, lengths

    def submit(self, arrays):
        """Enqueue one batch; returns an opaque handle.

        Does not wait for the device: decode and upload of the next batch
        can proceed while the device computes this one.
        """
        x, lengths = self._prep(arrays)
        if self.device.type != "cuda":
            return self._fn(x.to(self.device)), None, lengths, x
        y = self._fn(x.to(self.device, non_blocking=True))
        host = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
        host.copy_(y, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        # x stays referenced until collect: its upload may still be running.
        return host, done, lengths, x

    def collect(self, handle):
        """Fetch a submitted batch: list of [3, n_i] numpy arrays."""
        y, done, lengths, _ = handle
        if done is not None:
            done.synchronize()
        y = y.cpu().numpy()
        return [y[i, :, : lengths[i]] for i in range(len(lengths))]

    def process_files(self, arrays_iter, pipeline: bool = False):
        """Run an iterable of [2, n] arrays through fixed-size batches,
        yielding [3, n] results in order.

        `pipeline=True` keeps one batch in flight: the next batch's host
        prep and upload overlap the device computing the current one.
        """
        if not pipeline:
            chunk = []
            for a in arrays_iter:
                chunk.append(np.asarray(a, np.float32))
                if len(chunk) == self.batch_size:
                    yield from self.collect(self.submit(chunk))
                    chunk = []
            if chunk:
                yield from self.collect(self.submit(chunk))
            return
        pending = None
        chunk = []
        for a in arrays_iter:
            chunk.append(np.asarray(a, np.float32))
            if len(chunk) == self.batch_size:
                handle = self.submit(chunk)  # enqueue before draining previous
                if pending is not None:
                    yield from self.collect(pending)
                pending = handle
                chunk = []
        if chunk:
            handle = self.submit(chunk)
            if pending is not None:
                yield from self.collect(pending)
            pending = handle
        if pending is not None:
            yield from self.collect(pending)
