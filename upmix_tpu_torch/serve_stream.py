"""Multi-client live-stream server on the serving pool.

The port of `upmix_tpu/serve_stream.py`, with its names and its wire
protocol byte for byte, so a client of either package talks to a server
of either.  Each client connection claims one slot of a
`make_stream_pool` pool, and one pool dispatch per hardware block (or per
`hops` blocks) processes every live session together: on the card, the
pool kernel (K3, `csrc/pool.cu`) for every stream at once.

Wire protocol (little-endian, fixed-size frames after the handshake):

  client hello:  b"UPMX" | u32 version (1) | u32 mix (0=stereo_sum, 1=lcr)
  server reply:  b"UPMR" | u32 status (0 ok, 1 pool full, 2 bad hello)
                 | u32 slot | u32 hw_block | u32 out_channels
  v2 hello adds | 16-byte resume token (zeros = new session)
  v2 reply adds | 16-byte session token | u64 in_frames | u64 out_frames
                 | f64 sample_rate   (status 3 = unknown resume token)
  then, repeatedly:
    client -> server: hw_block * 2 float32 (interleaved stereo)
    server -> client: hw_block * out_channels float32 (interleaved)

Metrics query (any protocol version): a client may instead send b"UPMQ" |
u32 format | u32 0; the server replies u32 payload length + the payload
(format 0 = JSON `metrics_snapshot()`, 1 = Prometheus text) and closes.
The same snapshot is served over HTTP (GET /metrics, /metrics.json) when
the server is built with `metrics_http_port`.

Clients half-close (shutdown(SHUT_WR)) at end of stream; the server
drains the pool with zero blocks and closes when the output has caught
up with the input.  Output is warmup-aligned per connection: the slot's
leading warmup silence is dropped and the tail drained, so output frame
i corresponds to input frame i and every client gets back exactly as
many frames as it sent.  Short final blocks are zero-padded to hw_block
by the client and trimmed client-side (`stream_client` does both).

Tick modes: lockstep=True dispatches once every active slot has a cycle's
input queued (deterministic; for file-fed clients and tests);
lockstep=False dispatches every hops * hw / sr seconds of wall clock,
and slots whose block has not arrived get zeros.

Checkpoint/resume (protocol v2): `save_checkpoint(path)` freezes every
live session (the pool's per-slot rows, `extract_streams`; frame
counters; warmup skip; queued input blocks; a resume token) into one
.npz file.  A server started with `checkpoint=path` parks those
sessions: their slots are reserved and their rows stay host-side until
the client reconnects with its token (`load_streams`); the reply's
in_frames says where to resume sending, and in lockstep mode the
continued output is sample-exact with an uninterrupted run.  Input in
TCP flight at checkpoint time is not captured (resend from in_frames);
output past the checkpoint's out_frames is regenerated (discard it).

On the card the dispatcher stages each cycle's input through pinned host
memory, launches the step, gathers the live slots' outputs on the card
and starts their copy to pinned host memory, all on the pool's stream
with no synchronisation; it then waits on that copy's event.  With
pipeline=2 it waits on the previous cycle's copy after launching the
next cycle, so the host delivers cycle N-1 while the card computes N.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import socket
import struct
import threading
import time

import numpy as np
import torch

from upmix_tpu_torch.metrics import ServerMetrics, prometheus_text

log = logging.getLogger(__name__)

MAGIC_HELLO = b"UPMX"
MAGIC_REPLY = b"UPMR"
MAGIC_METRICS = b"UPMQ"
VERSION = 1
VERSION2 = 2
MIX_MODES = ("stereo_sum", "lcr")
_TOKEN_LEN = 16
_ZERO_TOKEN = b"\x00" * _TOKEN_LEN
# _flush_pending's default: deliver self._pending (None stays distinct:
# an explicit None means nothing to deliver).
_FLUSH_SELF_PENDING = object()

_ST_FREE, _ST_ACTIVE, _ST_DRAINING, _ST_PARKED = 0, 1, 2, 3


# -- tree <-> npz codec (checkpoint format) ----------------------------------

def _tree_encode(tree, arrays: dict, prefix: str):
    """Structure descriptor (JSON-safe) + flat array dict for a tree of
    dicts/tuples/lists of arrays (the pool snapshot shapes)."""
    if isinstance(tree, dict):
        return {"t": "d", "k": {str(k): _tree_encode(v, arrays, f"{prefix}.{k}") for k, v in tree.items()}}
    if isinstance(tree, (tuple, list)):
        return {
            "t": "t" if isinstance(tree, tuple) else "l",
            "c": [_tree_encode(v, arrays, f"{prefix}.{i}") for i, v in enumerate(tree)],
        }
    arrays[prefix] = np.asarray(tree)
    return {"t": "a", "key": prefix}


def _tree_decode(desc, arrays):
    if desc["t"] == "d":
        return {k: _tree_decode(v, arrays) for k, v in desc["k"].items()}
    if desc["t"] in ("t", "l"):
        vals = [_tree_decode(c, arrays) for c in desc["c"]]
        return tuple(vals) if desc["t"] == "t" else list(vals)
    return arrays[desc["key"]]


def _read_exact(sock, n):
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            break
        buf.extend(chunk)
    return bytes(buf)


class _Slot:
    __slots__ = ("state", "mix", "inq", "outq", "in_frames", "out_frames", "skip", "gen", "token", "parked",
                 "parked_at")

    def __init__(self):
        self.state = _ST_FREE
        self.mix = 0
        self.inq = None
        self.outq = None
        self.in_frames = 0
        self.out_frames = 0
        self.skip = 0
        self.gen = 0  # bumped per allocation; stale threads detect reuse
        self.token = _ZERO_TOKEN  # per-session resume key (v2 protocol)
        self.parked = None  # checkpointed session record awaiting resume
        self.parked_at = 0.0  # monotonic restore time (resume_ttl clock)


class StreamServer:
    """Serve a pool of live upmix sessions over TCP.

    `pool` is a `make_stream_pool` engine (CudaStreamPool or
    BatchStreamingUpmixer, on the card or the CPU); the server owns its
    state (push no blocks into it from outside while serving).

    ``hops=T`` dispatches T consecutive hardware blocks per cycle
    (`CudaStreamPool.push_blocks_multi`), dividing the per-block host and
    launch overhead by T at T block deadlines of added input latency; in
    lockstep mode clients must send >= T blocks ahead.  The histograms
    then record per-cycle times; `stats["blocks"]` counts hardware blocks.

    ``pipeline=2`` keeps one cycle in flight: the dispatcher launches
    cycle N, then waits for and delivers cycle N-1's outputs while the
    card computes N, at one cycle of added output latency.  The dispatch
    histogram then records the blocking wait for the previous cycle's
    outputs, and the cycle histogram each cycle's dispatch-to-delivery
    latency; throughput is `stats["blocks"] / wall`.
    """

    def __init__(
        self,
        pool,
        host: str = "127.0.0.1",
        port: int = 0,
        lockstep: bool = True,
        sr: float | None = None,
        max_buffered_blocks: int = 32,
        checkpoint: "str | dict | None" = None,
        snapshot_every: float | None = None,
        metrics_http_port: int | None = None,
        hops: int = 1,
        pipeline: int = 1,
        resume_ttl: float | None = None,
    ):
        self.pool = pool
        self.hw = int(pool.hw_block_size)
        self.n_slots = int(pool.n_streams)
        self.lockstep = bool(lockstep)
        if not lockstep and not sr:
            raise ValueError("realtime mode needs sr for the tick period")
        self.hops = int(hops)
        if self.hops < 1:
            raise ValueError(f"hops must be >= 1, got {hops}")
        if self.hops > int(max_buffered_blocks):
            raise ValueError(
                f"hops ({hops}) cannot exceed max_buffered_blocks ({max_buffered_blocks}): a slot's queue could "
                "never hold one full cycle"
            )
        if self.hops > 1 and not hasattr(pool, "push_blocks_multi"):
            raise ValueError(
                f"hops > 1 needs a pool with the multi-hop step (CudaStreamPool); {type(pool).__name__} has only "
                "the single-block step"
            )
        self._push = pool.push_blocks_multi if self.hops > 1 else pool.push_blocks
        self.pipeline = int(pipeline)
        if self.pipeline not in (1, 2):
            raise ValueError(f"pipeline must be 1 (synchronous) or 2 (one cycle in flight), got {pipeline}")
        self._device = torch.device(pool.device)
        self._rows = (None, None)  # (live slot indices, their index tensor on the pool's device)
        # In-flight cycle: (_launch's handle, live slot list, cycle start
        # time).  Written only under _pool_lock.
        self._pending = None
        self.tick_period = (self.hw * self.hops / float(sr)) if sr else None
        # Parked-session time-to-live: with resume_ttl set, expired parked
        # slots are reclaimed lazily when an allocation would otherwise
        # fail.  None = hold forever; ttl <= 0 = reclaim when a slot is needed.
        self.resume_ttl = float(resume_ttl) if resume_ttl is not None else None
        self.max_buffered_blocks = int(max_buffered_blocks)
        self._slots = [_Slot() for _ in range(self.n_slots)]
        if checkpoint is not None:
            self._load_checkpoint(checkpoint)
        self._lock = threading.Lock()
        # Serializes every touch of the pool's state (the dispatcher's push
        # against connection threads' reset_streams / load_streams).  Lock
        # order wherever both are held: _pool_lock outer, _lock inner.
        self._pool_lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._threads = []
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, int(port)))
        self._sock.listen()
        self.address = self._sock.getsockname()
        self.metrics = ServerMetrics()
        self.stats = self.metrics.counters  # the same dict
        self._t0 = time.monotonic()
        self._metrics_http_port = metrics_http_port
        self._http = None
        self.metrics_http_address = None
        self.snapshot_path = None  # set by run_stream_server (the CLI saves here)
        # Periodic checkpointing (needs snapshot_path); its capture pauses
        # dispatch while the pool state copies to the host.
        self.snapshot_every = float(snapshot_every) if snapshot_every else None

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        loops = [self._accept_loop, self._dispatch_loop]
        if self.snapshot_every:
            loops.append(self._snapshot_loop)
        for fn in loops:
            t = threading.Thread(target=fn, daemon=True)
            t.start()
            self._threads.append(t)
        if self._metrics_http_port is not None:
            self._start_metrics_http(self._metrics_http_port)
        return self

    # -- observability -------------------------------------------------------

    def metrics_snapshot(self) -> dict:
        """Point-in-time metrics: counters and latency histograms (from
        `self.metrics`) plus state gauges and static config info."""
        with self._lock:
            states = [s.state for s in self._slots]
            queued = sum(s.inq.qsize() for s in self._slots if s.inq is not None)
        snap = self.metrics.snapshot()
        snap["gauges"] = {
            "slots_active": states.count(_ST_ACTIVE),
            "slots_draining": states.count(_ST_DRAINING),
            "slots_parked": states.count(_ST_PARKED),
            "slots_free": states.count(_ST_FREE),
            "queued_input_blocks": queued,
            "uptime_seconds": time.monotonic() - self._t0,
        }
        snap["config"] = {
            "engine": type(self.pool).__name__,
            "hw_block": self.hw,
            "n_slots": self.n_slots,
            "sr": float(self.pool.config.sr),
            "lockstep": self.lockstep,
            "hops": self.hops,
            "pipeline": self.pipeline,
        }
        return snap

    def _start_metrics_http(self, port: int):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        server = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                if self.path in ("/metrics", "/metrics.json"):
                    snap = server.metrics_snapshot()
                    if self.path == "/metrics":
                        body = prometheus_text(snap).encode()
                        ctype = "text/plain; version=0.0.4"
                    else:
                        body = json.dumps(snap).encode()
                        ctype = "application/json"
                    self.send_response(200)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self.send_error(404)

            def log_message(self, *args):
                pass  # no per-scrape stderr noise

        self._http = ThreadingHTTPServer((self.address[0], int(port)), _Handler)
        self.metrics_http_address = self._http.server_address
        t = threading.Thread(target=self._http.serve_forever, daemon=True)
        t.start()
        self._threads.append(t)

    def _snapshot_loop(self):
        while not self._stop.wait(self.snapshot_every):
            if self.snapshot_path is None:
                continue
            try:
                self.save_checkpoint(self.snapshot_path)
            except Exception:
                log.exception("periodic session checkpoint failed")

    def _end_sessions(self):
        """End-of-stream sentinel to every live session: each writer thread
        closes its socket, so clients see a short read, not a hang."""
        with self._lock:
            for s in self._slots:
                if s.state not in (_ST_FREE, _ST_PARKED) and s.outq is not None:
                    s.outq.put(None)

    def _close_listener(self):
        # shutdown() before close(): closing the fd does not wake a thread
        # blocked in accept() on Linux, which would keep the port bound.
        for fn in (lambda: self._sock.shutdown(socket.SHUT_RDWR), self._sock.close):
            try:
                fn()
            except OSError:
                pass

    def close(self):
        self._stop.set()
        self._wake.set()
        # Without the sentinels each connection's writer blocks in
        # outq.get() and its socket lingers: a server restarted on the same
        # port would get EADDRINUSE.
        self._end_sessions()
        self._close_listener()
        if self._http is not None:
            self._http.shutdown()
            self._http.server_close()
        for t in self._threads:
            t.join(timeout=5.0)

    # -- checkpoint / resume -------------------------------------------------

    def _pool_identity(self) -> dict:
        """What must match for a checkpoint to restore into this server,
        JSON-canonicalized (tuples become lists) so it compares equal to
        one round-tripped through the .npz metadata."""
        from upmix_tpu_torch.config import config_to_dict

        ident = {
            "engine": type(self.pool).__name__,
            "ola": getattr(self.pool, "ola", ""),
            "hw": self.hw,
            "n_streams": self.n_slots,
            "config": config_to_dict(self.pool.config),
        }
        return json.loads(json.dumps(ident))

    def save_checkpoint(self, path: str) -> int:
        """Freeze every live session to `path` (.npz); returns how many.

        Non-destructive and safe at any time: the capture runs under
        _pool_lock and _lock (a dispatcher cycle is atomic under the same
        locks), queued input blocks are copied, not drained, and the file
        is written outside the locks.  Draining sessions are saved too (a
        resumed drain client reconnects, sends nothing and half-closes
        again); parked sessions are carried forward as they are.  The
        capture copies the pool state to the host, pausing dispatch.
        """
        arrays: dict = {}
        sessions = []
        with self._pool_lock:
            # pipeline=2: the pool state already includes the in-flight
            # cycle, so its outputs must reach the slots' out_frames first:
            # they are never generated again.
            self._flush_pending()
            with self._lock:
                snap = self.pool.snapshot()
                for i, s in enumerate(self._slots):
                    if s.state in (_ST_ACTIVE, _ST_DRAINING):
                        blocks = list(s.inq.queue)  # peek: every queue mutation holds _lock
                        rec = {
                            "rows": self.pool.extract_streams([i], snap=snap),
                            "blocks": np.stack(blocks) if blocks else np.zeros((0, self.hw, 2), np.float32),
                            "in_frames": s.in_frames,
                            "out_frames": s.out_frames,
                            "skip": s.skip,
                            "token": s.token,
                        }
                    elif s.state == _ST_PARKED:
                        rec = s.parked
                    else:
                        continue
                    key = f"s{i}"
                    desc = _tree_encode(rec["rows"], arrays, f"{key}.rows")
                    arrays[f"{key}.blocks"] = rec["blocks"]
                    sessions.append({
                        "slot": i,
                        "rows": desc,
                        "in_frames": int(rec["in_frames"]),
                        "out_frames": int(rec["out_frames"]),
                        "skip": int(rec["skip"]),
                        "token": rec["token"].hex(),
                    })
        meta = {"format": 1, "identity": self._pool_identity(), "sessions": sessions}
        tmp = f"{path}.tmp"
        with open(tmp, "wb") as f:
            np.savez(f, __meta__=np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8), **arrays)
        os.replace(tmp, path)
        self.stats["checkpoints"] += 1
        return len(sessions)

    def _load_checkpoint(self, checkpoint):
        if isinstance(checkpoint, (str, os.PathLike)):
            with np.load(checkpoint) as z:
                data = {k: z[k] for k in z.files}
        else:
            data = dict(checkpoint)
        meta = json.loads(bytes(data.pop("__meta__").tobytes()).decode("utf-8"))
        if meta.get("format") != 1:
            raise ValueError(f"unsupported stream-server checkpoint format {meta.get('format')!r}")
        want = self._pool_identity()
        have = meta["identity"]
        if have != want:
            diff = [k for k in want if have.get(k) != want[k]]
            raise ValueError(f"checkpoint does not match this server's pool (mismatched: {diff})")
        for sess in meta["sessions"]:
            i = int(sess["slot"])
            s = self._slots[i]
            s.state = _ST_PARKED
            s.parked_at = time.monotonic()
            s.token = bytes.fromhex(sess["token"])
            s.parked = {
                "rows": _tree_decode(sess["rows"], data),
                "blocks": data[f"s{i}.blocks"],
                "in_frames": int(sess["in_frames"]),
                "out_frames": int(sess["out_frames"]),
                "skip": int(sess["skip"]),
                "token": s.token,
            }

    def _resume_slot(self, token: bytes, mix: int):
        """Claim a parked session by token: its rows go into the pool and
        the slot goes active in one step under _pool_lock and _lock (else
        the dispatcher could run its queued blocks on the fresh pool's
        zero row first)."""
        with self._pool_lock, self._lock:
            if self._stop.is_set():
                return None, None  # stopping: see _alloc_slot
            found = [(i, s) for i, s in enumerate(self._slots) if s.state == _ST_PARKED and s.token == token]
            if not found:
                return None, None
            idx, slot = found[0]
            rec = slot.parked
            self.pool.load_streams([idx], rec["rows"])
            slot.state = _ST_ACTIVE
            slot.parked = None
            slot.mix = mix
            slot.inq = queue.Queue(maxsize=max(self.max_buffered_blocks, len(rec["blocks"]) + 1))
            slot.outq = queue.Queue()
            slot.in_frames = rec["in_frames"]
            slot.out_frames = rec["out_frames"]
            slot.skip = rec["skip"]
            slot.gen += 1
            for blk in rec["blocks"]:
                slot.inq.put_nowait(np.asarray(blk, np.float32))
            self.stats["resumed"] += 1
            self.stats["accepted"] += 1
        self._wake.set()
        return idx, slot

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()

    # -- connection handling ----------------------------------------------

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                return  # socket closed
            threading.Thread(target=self._serve_conn, args=(conn,), daemon=True).start()

    def _alloc_slot(self, mix):
        with self._lock:
            if self._stop.is_set():
                # Stopping (close() or a dispatcher failure): a connection
                # accepted but not yet allocated must not wait on an output
                # queue nothing fills.
                return None, None
            if self.resume_ttl is not None and not any(s.state == _ST_FREE for s in self._slots):
                now = time.monotonic()  # lazy reclaim: only when the allocation would fail
                for s in self._slots:
                    if s.state == _ST_PARKED and now - s.parked_at > self.resume_ttl:
                        s.state = _ST_FREE
                        s.parked = None
                        s.token = _ZERO_TOKEN  # a late resume gets status 3
                        self.stats["parked_expired"] += 1
            for i, s in enumerate(self._slots):
                if s.state == _ST_FREE:
                    s.state = _ST_ACTIVE
                    s.mix = mix
                    # Bounded: a file-fed client cannot buffer its whole
                    # signal here; TCP backpressure stalls it instead.
                    s.inq = queue.Queue(maxsize=self.max_buffered_blocks)
                    s.outq = queue.Queue()
                    s.in_frames = s.out_frames = 0
                    s.skip = (self.pool.warmup_blocks - 1) * self.hw
                    s.gen += 1
                    s.token = os.urandom(_TOKEN_LEN)
                    self.stats["accepted"] += 1
                    return i, s
        return None, None

    def _release_slot(self, s):
        with self._lock:
            s.state = _ST_FREE
            s.inq = s.outq = None
        self._wake.set()

    def _reply(self, conn, version, status, idx=0, out_ch=0, slot=None):
        head = MAGIC_REPLY + struct.pack("<IIII", status, idx, self.hw if status == 0 else 0, out_ch)
        if version >= VERSION2:
            token = slot.token if slot is not None else _ZERO_TOKEN
            in_f = slot.in_frames if slot is not None else 0
            out_f = slot.out_frames if slot is not None else 0
            head += token + struct.pack("<QQd", in_f, out_f, float(self.pool.config.sr))
        conn.sendall(head)

    def _serve_conn(self, conn):
        slot = None
        writer = None
        try:
            hello = _read_exact(conn, 12)
            if len(hello) == 12 and hello[:4] == MAGIC_METRICS:
                fmt = struct.unpack("<I", hello[4:8])[0]
                snap = self.metrics_snapshot()
                payload = prometheus_text(snap).encode() if fmt == 1 else json.dumps(snap).encode()
                conn.sendall(struct.pack("<I", len(payload)) + payload)
                return
            version = struct.unpack("<I", hello[4:8])[0] if len(hello) == 12 else 0
            ok = (
                len(hello) == 12
                and hello[:4] == MAGIC_HELLO
                and version in (VERSION, VERSION2)
                and struct.unpack("<I", hello[8:12])[0] < len(MIX_MODES)
            )
            token = _ZERO_TOKEN
            if ok and version >= VERSION2:
                token = _read_exact(conn, _TOKEN_LEN)
                ok = len(token) == _TOKEN_LEN
            if not ok:
                self._reply(conn, max(version, VERSION), 2)
                return
            mix = struct.unpack("<I", hello[8:12])[0]
            if version >= VERSION2 and token != _ZERO_TOKEN:
                idx, slot = self._resume_slot(token, mix)
                if slot is None:
                    self._reply(conn, version, 3)
                    with self._lock:
                        self.stats["rejected"] += 1
                    return
            else:
                # Claiming the slot and zeroing its pool rows is one step
                # under _pool_lock: a checkpoint between them would save the
                # previous session's history under the new token.
                with self._pool_lock:
                    idx, slot = self._alloc_slot(mix)
                    if slot is not None:
                        self.pool.reset_streams([idx])  # the slot re-warms from silence
                if slot is None:
                    self._reply(conn, version, 1)
                    with self._lock:
                        self.stats["rejected"] += 1
                    return
            out_ch = 3 if MIX_MODES[mix] == "lcr" else 2
            self._reply(conn, version, 0, idx, out_ch, slot)

            writer = threading.Thread(target=self._writer_loop, args=(conn, slot.outq), daemon=True)
            writer.start()
            gen = slot.gen
            block_bytes = self.hw * 2 * 4
            while True:
                raw = _read_exact(conn, block_bytes)
                if len(raw) < block_bytes:
                    break  # EOF (half-close) or a dead connection
                x = np.frombuffer(raw, dtype="<f4").reshape(self.hw, 2)
                # The enqueue and the in_frames ack are one step under _lock
                # (a checkpoint between them would ack a block it never
                # saved, or save one it never acked); a full queue is
                # retried outside the lock.
                enqueued = False
                while not enqueued:
                    with self._lock:
                        if slot.gen != gen or slot.state != _ST_ACTIVE:
                            break  # slot torn down underneath us
                        try:
                            slot.inq.put_nowait(x)
                            slot.in_frames += self.hw
                            enqueued = True
                        except queue.Full:
                            pass
                    if not enqueued:
                        if self._stop.is_set():
                            break
                        self._stop.wait(0.01)  # backpressure: TCP stalls the client meanwhile
                if not enqueued:
                    break
                self._wake.set()
        except (OSError, ValueError):
            pass  # client gone mid-stream; the drain below frees the slot
        finally:
            # Every exit path moves an allocated slot to DRAINING, or the
            # slot leaks and a lockstep dispatcher waits on it forever.
            if slot is not None:
                with self._lock:
                    if slot.state == _ST_ACTIVE:
                        slot.state = _ST_DRAINING
                self._wake.set()
                if writer is not None:
                    writer.join()
            try:
                conn.close()
            except OSError:
                pass

    def _writer_loop(self, conn, outq):
        # The queue object is captured here: the dispatcher nulls slot.outq
        # when it frees the slot.
        while True:
            item = outq.get()
            if item is None:
                try:
                    conn.shutdown(socket.SHUT_WR)
                except OSError:
                    pass
                return
            try:
                conn.sendall(item)
            except OSError:
                return  # client vanished: the reader sees EOF and the slot drains

    # -- the pool dispatcher ----------------------------------------------

    def _ready(self):
        """Lockstep rule: every ACTIVE slot has a cycle's input (hops
        blocks) queued and at least one slot needs processing."""
        any_live = False
        for s in self._slots:
            if s.state == _ST_ACTIVE:
                any_live = True
                if s.inq.qsize() < self.hops:
                    return False
            elif s.state == _ST_DRAINING:
                any_live = True
        return any_live

    def _launch(self, x: np.ndarray, rows: tuple):
        """One cycle on the pool: x [len(rows), 2, hops*hw] float32, the
        live slots' input (every other slot gets silence); returns a
        handle for `_fetch` to their outputs [3, len(rows), hops*hw] (C,
        Ls, Rs).  On the card nothing here waits for the device: the live
        rows go through pinned memory and are scattered into the pool's
        input there, and their outputs are gathered on the card and copied
        to pinned memory behind an event."""
        cuda = self._device.type == "cuda"
        if rows != self._rows[0]:
            index = torch.tensor(rows, dtype=torch.long)
            self._rows = (rows, index.pin_memory().to(self._device, non_blocking=True) if cuda else index)
        index = self._rows[1]
        xt = torch.from_numpy(x)
        if cuda:
            xt = xt.pin_memory().to(self._device, non_blocking=True)
        full = torch.zeros((self.n_slots, *xt.shape[1:]), device=self._device).index_copy_(0, index, xt)
        c, ls, rs = self._push(full[:, 0], full[:, 1])
        out = torch.stack([c, ls, rs]).index_select(1, index)
        if not cuda:
            return out, None
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self._device))
        return host, done

    @staticmethod
    def _fetch(handle) -> np.ndarray:
        out, done = handle
        if done is not None:
            done.synchronize()
        return out.numpy()

    def _flush_pending(self, cycle=_FLUSH_SELF_PENDING, t0=None):
        """Fetch and deliver one cycle's outputs: the in-flight cycle (no
        argument: pipeline=2's parked work) or an explicit (handle, live,
        t_cycle) tuple.  The only delivery path.

        ``t0`` sets the dispatch histogram's start: the synchronous path
        passes its pre-dispatch time (dispatch + fetch); without it the
        histogram records the blocking fetch wait alone.

        Caller holds _pool_lock (and not _lock)."""
        if cycle is _FLUSH_SELF_PENDING:
            cycle, self._pending = self._pending, None
        if cycle is None:
            return
        handle, live, t_cycle = cycle
        t_fetch = time.monotonic() if t0 is None else t0
        out = self._fetch(handle)
        self.metrics.dispatch_seconds.record(time.monotonic() - t_fetch)
        self._account_cycle(out, live, t_cycle)

    def _account_cycle(self, out, live, t_cycle):
        """Deliver one cycle's outputs (out [3, len(live), width], in
        `live`'s order) to the live slots.  Caller holds _pool_lock; takes
        _lock per slot."""
        c, ls, rs = out
        half_c = 0.5 * c
        mix_l, mix_r = ls + half_c, rs + half_c  # mixed once for every live slot
        for j, (_i, s, gen) in enumerate(live):
            with self._lock:
                if s.gen != gen or s.state == _ST_FREE:
                    continue
                if MIX_MODES[s.mix] == "lcr":
                    frames = np.column_stack([c[j], ls[j], rs[j]])
                else:
                    frames = np.column_stack([mix_l[j], mix_r[j]])
                if s.skip:
                    k = min(s.skip, len(frames))
                    frames = frames[k:]
                    s.skip -= k
                frames = frames[: max(0, s.in_frames - s.out_frames)]
                if len(frames):
                    s.out_frames += len(frames)
                    self.stats["frames"] += len(frames)
                    s.outq.put(np.ascontiguousarray(frames).astype("<f4").tobytes())
                done = s.state == _ST_DRAINING and s.inq.empty() and s.out_frames >= s.in_frames
            if done:
                s.outq.put(None)
                self._release_slot(s)
        self.metrics.cycle_seconds.record(time.monotonic() - t_cycle)

    def _dispatch_loop(self):
        """Thread body: run cycles until stop.  On a failure fail fast: the
        dispatcher is the only thread that moves blocks through the pool,
        so a silent death would leave every client blocked on an output
        queue nothing fills."""
        try:
            self._dispatch_cycles()
        except Exception:
            log.exception("stream dispatcher died; failing all live sessions")
            self.stats["dispatcher_failures"] += 1
            # _stop before the sentinel sweep: admissions check it under
            # _lock, so none that wins the lock after the sweep is admitted.
            self._stop.set()
            self._end_sessions()
            self._wake.set()
            self._close_listener()  # refuse new clients too

    def _dispatch_cycles(self):
        hw, T = self.hw, self.hops
        zeros_blk = np.zeros((hw, 2), np.float32)
        next_tick = None
        while not self._stop.is_set():
            if self.lockstep:
                with self._lock:
                    ready = self._ready()
                if not ready:
                    # No cycle to build: deliver the in-flight outputs first
                    # (pipeline=2), or a paused client would wait on them.
                    if self._pending is not None:
                        with self._pool_lock:
                            self._flush_pending()
                        continue
                    self._wake.wait(timeout=0.05)
                    self._wake.clear()
                    continue
            else:
                # Deadline to deadline, so dispatch time does not stretch
                # the block rate.
                now = time.monotonic()
                if next_tick is None:
                    next_tick = now + self.tick_period
                elif next_tick > now:
                    self._stop.wait(next_tick - now)
                    next_tick += self.tick_period
                else:  # fell behind: do not burst
                    next_tick = now + self.tick_period
                with self._lock:
                    # Parked sessions count as idle: a restarted server whose
                    # clients have not resumed yet sleeps.
                    idle = not any(s.state not in (_ST_FREE, _ST_PARKED) for s in self._slots)
                if idle:
                    if self._pending is not None:
                        with self._pool_lock:
                            self._flush_pending()
                    next_tick = None  # re-anchor the clock on the next client
                    self._wake.wait(timeout=self.tick_period)
                    self._wake.clear()
                    continue
            # The whole cycle (pop the queued blocks, push the pool, account
            # the outputs) runs under _pool_lock, so a checkpoint only sees
            # quiesced boundaries.
            with self._pool_lock:
                t_cycle = time.monotonic()
                live, inputs = [], []
                with self._lock:
                    # Re-check under the cycle's locks: a slot can go ACTIVE
                    # (a resume with an empty queue) since the unlocked poll,
                    # and a silent block in mid-stream would corrupt it.
                    if self.lockstep and not self._ready():
                        continue
                    for i, s in enumerate(self._slots):
                        if s.state in (_ST_FREE, _ST_PARKED):
                            continue  # a parked session's rows live host-side
                        live.append((i, s, s.gen))
                        parts = []
                        while len(parts) < T:
                            try:
                                parts.append(s.inq.get_nowait())
                            except queue.Empty:
                                break
                        if s.state == _ST_ACTIVE and len(parts) < T:
                            # A late client (realtime mode only): zeros.
                            self.stats["late_zero_blocks"] += T - len(parts)
                        parts += [zeros_blk] * (T - len(parts))  # a draining tail pads with silence
                        inputs.append(np.concatenate(parts, axis=0).T)
                t_dispatch = time.monotonic()
                handle = self._launch(np.stack(inputs), tuple(i for i, _, _ in live))
                self.stats["blocks"] += T
                cycle = (handle, live, t_cycle)
                if self.pipeline > 1:
                    # Deliver the previous cycle while the card computes this one.
                    prev, self._pending = self._pending, cycle
                    self._flush_pending(prev)
                else:
                    self._flush_pending(cycle, t0=t_dispatch)
        # Shutdown: deliver anything still in flight.
        with self._pool_lock:
            self._flush_pending()


class StreamSession:
    """Protocol-v2 client session: block-level streaming with a resume
    token.  Connect fresh (token=None) or resume a checkpointed session;
    after a resume, ``server_in_frames`` says how many input frames the
    server already holds: resend the signal from that offset and skip the
    output frames already received.  `stream_client` is the one-shot
    whole-signal convenience."""

    def __init__(self, host, port, mix="stereo_sum", token=None, timeout=60.0):
        if mix not in MIX_MODES:
            raise ValueError(f"mix must be one of {MIX_MODES}, got {mix!r}")
        self.sock = socket.create_connection((host, port), timeout=timeout)
        try:
            tok = token if token is not None else _ZERO_TOKEN
            if len(tok) != _TOKEN_LEN:
                raise ValueError(f"token must be {_TOKEN_LEN} bytes")
            self.sock.sendall(MAGIC_HELLO + struct.pack("<II", VERSION2, MIX_MODES.index(mix)) + tok)
            reply = _read_exact(self.sock, 20 + _TOKEN_LEN + 24)
            if len(reply) < 20 + _TOKEN_LEN + 24 or reply[:4] != MAGIC_REPLY:
                raise ConnectionError("bad server reply")
            status, self.slot, self.hw, self.out_channels = struct.unpack("<IIII", reply[4:20])
            self.token = reply[20 : 20 + _TOKEN_LEN]
            self.server_in_frames, self.server_out_frames, self.server_sr = struct.unpack(
                "<QQd", reply[20 + _TOKEN_LEN : 44 + _TOKEN_LEN]
            )
            if status == 1:
                raise ConnectionError("server pool is full")
            if status == 3:
                raise ConnectionError("unknown or expired resume token")
            if status != 0:
                raise ConnectionError(f"server rejected hello (status {status})")
        except Exception:
            self.sock.close()
            raise

    def send_block(self, in_l, in_r):
        """One hw block (each channel length hw; zero-pad short tails)."""
        frame = np.column_stack([np.asarray(in_l, "<f4"), np.asarray(in_r, "<f4")])
        if frame.shape != (self.hw, 2):
            raise ValueError(f"send_block expects two length-{self.hw} channels")
        self.sock.sendall(frame.tobytes())

    def recv_frames(self, n):
        """Read exactly n output frames -> [n, out_channels] float32."""
        raw = _read_exact(self.sock, n * self.out_channels * 4)
        if len(raw) < n * self.out_channels * 4:
            raise ConnectionError(f"short stream: got {len(raw) // (self.out_channels * 4)} of {n} frames")
        return np.frombuffer(raw, "<f4").reshape(n, self.out_channels)

    def finish(self):
        """Half-close: no more input; the server drains and closes."""
        try:
            self.sock.shutdown(socket.SHUT_WR)
        except OSError:
            pass

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def stream_client(host, port, in_l, in_r, mix="stereo_sum", timeout=60.0, expect_sr=None):
    """Reference client: stream a whole stereo signal through a
    StreamServer and return the processed channels, trimmed to the input
    length.  Sends and receives concurrently, zero-padding the final short
    block.  Speaks protocol v2 as a fresh session; `expect_sr` checks the
    server's sample rate against the signal's before sending a byte."""
    if mix not in MIX_MODES:
        raise ValueError(f"mix must be one of {MIX_MODES}, got {mix!r}")
    in_l = np.asarray(in_l, np.float32)
    in_r = np.asarray(in_r, np.float32)
    n = len(in_l)
    sock = socket.create_connection((host, port), timeout=timeout)
    try:
        sock.sendall(MAGIC_HELLO + struct.pack("<II", VERSION2, MIX_MODES.index(mix)) + _ZERO_TOKEN)
        reply = _read_exact(sock, 20 + _TOKEN_LEN + 24)
        if len(reply) < 20 + _TOKEN_LEN + 24 or reply[:4] != MAGIC_REPLY:
            raise ConnectionError("bad server reply")
        status, _slot, hw, out_ch = struct.unpack("<IIII", reply[4:20])
        (server_sr,) = struct.unpack("<d", reply[36 + _TOKEN_LEN : 44 + _TOKEN_LEN])
        if status == 1:
            raise ConnectionError("server pool is full")
        if status != 0:
            raise ConnectionError(f"server rejected hello (status {status})")
        if expect_sr is not None and abs(server_sr - float(expect_sr)) > 1e-6:
            raise ValueError(
                f"server runs at {server_sr:g} Hz but the signal is {float(expect_sr):g} Hz: resample or use a "
                "matching server"
            )
        pad = (-n) % hw
        xl = np.concatenate([in_l, np.zeros(pad, np.float32)])
        xr = np.concatenate([in_r, np.zeros(pad, np.float32)])
        frames = np.column_stack([xl, xr]).astype("<f4")
        total = len(xl)

        def send():
            try:
                for i in range(0, total, hw):
                    sock.sendall(frames[i : i + hw].tobytes())
                sock.shutdown(socket.SHUT_WR)
            except OSError:
                pass

        tx = threading.Thread(target=send, daemon=True)
        tx.start()
        out = bytearray()
        want = total * out_ch * 4
        while len(out) < want:
            chunk = sock.recv(min(1 << 16, want - len(out)))
            if not chunk:
                break
            out.extend(chunk)
        tx.join()
        got = np.frombuffer(bytes(out), dtype="<f4").reshape(-1, out_ch)
        if len(got) < total:
            raise ConnectionError(f"short stream: got {len(got)} of {total} frames")
        return tuple(np.ascontiguousarray(got[:n, ch]) for ch in range(out_ch))
    finally:
        sock.close()


def fetch_metrics(host: str, port: int, fmt: str = "json"):
    """Query a running StreamServer's metrics over its own port: fmt="json"
    returns the parsed `metrics_snapshot()` dict, fmt="prometheus" the
    text exposition."""
    fmt_code = {"json": 0, "prometheus": 1}[fmt]
    with socket.create_connection((host, int(port))) as sock:
        sock.sendall(MAGIC_METRICS + struct.pack("<II", fmt_code, 0))
        head = _read_exact(sock, 4)
        if len(head) < 4:
            raise ConnectionError("metrics query: short reply")
        (n,) = struct.unpack("<I", head)
        payload = _read_exact(sock, n)
    if len(payload) < n:
        raise ConnectionError("metrics query: truncated payload")
    if fmt == "json":
        return json.loads(payload.decode("utf-8"))
    return payload.decode("utf-8")


def run_stream_server(
    port: int,
    sr: float,
    n_streams: int = 16,
    hw_block_size: int = 2048,
    band_edges=(0, 500, 2000, 8000),
    host: str = "127.0.0.1",
    lockstep: bool = False,
    window: str = "blackman_harris",
    xover_mode: str = "raised_cosine",
    threshold_factor: float = 32.0,
    synthesis: str = "analysis",
    bin_rounding: str = "cpp",
    verbose: bool = True,
    engine: str = "auto",
    ola: str = "time",
    group: int = 16,
    mesh=None,
    snapshot_path: str | None = None,
    snapshot_every: float | None = None,
    metrics_http_port: int | None = None,
    hops: int = 1,
    pipeline: int = 1,
    resume_ttl: float | None = None,
    device="cuda",
) -> StreamServer:
    """The CLI's entry: build the pool and start serving (until close()).

    Defaults mirror the streaming config of the reference Bela setup
    (bela/upmix.cpp:525-528); lockstep defaults to False: a network server
    ticks on the wall clock like an audio callback.  engine ("auto",
    "cuda", "torch"), device, mesh and ola go to `make_stream_pool`: "auto"
    is the CUDA pool on the card (the pool kernel of `ola`'s dataflow),
    the batch pool on the CPU (device="cpu", which the caller asks for)
    or with a mesh; a mesh splits the slots over its 'data' axis and the
    checkpoints keep the unsharded structure.  `group`, the
    JAX pool's streams per TPU grid step, which the JAX package's CLI
    passes, is accepted and ignored: the card's pool has no group.

    snapshot_path: if the file exists, restore the checkpointed sessions
    from it (they park until their clients reconnect with their tokens);
    the CLI saves back to it on shutdown.
    """
    from upmix_tpu_torch.config import UpmixConfig
    from upmix_tpu_torch.models.streaming import make_stream_pool

    del group  # a TPU grid-step size: the card's pool has none
    config = UpmixConfig.streaming(
        list(band_edges), sr=float(sr), hw_block_size=int(hw_block_size), window=window, xover_mode=xover_mode,
        threshold_factor=threshold_factor, synthesis=synthesis, bin_rounding=bin_rounding,
    )
    pool = make_stream_pool(config, int(hw_block_size), int(n_streams), engine=engine, device=device, mesh=mesh,
                            ola=ola)
    checkpoint = snapshot_path if snapshot_path is not None and os.path.exists(snapshot_path) else None
    server = StreamServer(
        pool, host=host, port=port, lockstep=lockstep, sr=float(sr), checkpoint=checkpoint,
        snapshot_every=snapshot_every, metrics_http_port=metrics_http_port, hops=hops, pipeline=pipeline,
        resume_ttl=resume_ttl,
    )
    server.snapshot_path = snapshot_path
    server.start()
    if verbose:
        parked = sum(1 for s in server._slots if s.state == _ST_PARKED)
        resumed = f", {parked} parked sessions" if parked else ""
        http_note = ""
        if server.metrics_http_address is not None:
            http_note = f", metrics http://{server.metrics_http_address[0]}:{server.metrics_http_address[1]}/metrics"
        print(
            f"upmix-tpu stream server on {server.address[0]}:{server.address[1]} — {n_streams} slots, hw "
            f"{hw_block_size}, engine {type(pool).__name__} on {pool.device}{resumed}{http_note}",
            flush=True,
        )
    return server
