"""repro_torch.service.fabric.proc — the out-of-process shard fabric (the
port of ``repro.service.fabric.proc``).

Moves the sharded execution fabric across real process boundaries: each
shard is a :class:`~repro_torch.service.server.StratumService` hosted in
its own worker process (``python -m
repro_torch.service.fabric.proc.worker``) behind a length-prefixed framed
byte channel over a localhost socket, so K shards actually use K cores
instead of sharing one GIL.  The pieces:

* :mod:`frames`     — stream framing (4-byte length prefix + the existing
  checksummed envelope codec) with incremental partial-read reassembly,
  plus the supervisor↔worker control-frame codec (hello/config/heartbeat/
  drain/handoff);
* :mod:`transport`  — :class:`ProcTransport`, the socket-backed
  :class:`~repro_torch.service.fabric.transport.Transport` carrying the
  *unchanged* Job/Result/Cancel envelopes, with a client-side admission
  window that preserves ``Session.submit``'s synchronous
  ``AdmissionError`` contract;
* :mod:`worker`     — the shard worker entrypoint: one service per
  process, decode → execute → reply, heartbeats, graceful SIGTERM drain;
* :mod:`supervisor` — spawns and monitors workers (handshake, heartbeat
  health checks, crash/hang detection, reconnect grace) and reaps them;
* :mod:`autoscale`  — the elastic control loop: spawn shards under
  queue-depth/deadline pressure, drain idle shards with a warm cache
  hand-off to the ring successor;
* :mod:`fabric`     — :class:`ProcStratumFabric`, the drop-in
  :class:`~repro_torch.service.fabric.fabric.StratumFabric` over processes
  (``StratumClient`` reaches it via ``processes=True``).

A crashed worker (real ``kill -9``) is detected by socket EOF or
heartbeat timeout and routed into the existing ``fail_shard`` requeue
machinery — zero job loss, deadline budgets re-derived at requeue.

Every worker builds its service on the fabric's device, the card unless
``"cpu"``; K workers on one card are K CUDA contexts whose kernels
time-slice, so the process fabric adds host parallelism (K interpreters),
not device parallelism.
"""

from .autoscale import Autoscaler, AutoscalePolicy
from .fabric import ProcStratumFabric
from .frames import (FrameDecoder, FrameError, decode_control,
                     encode_control, write_frame)
from .supervisor import ProcConfig, WorkerSupervisor
from .transport import ProcTransport

__all__ = [
    "Autoscaler", "AutoscalePolicy", "FrameDecoder", "FrameError",
    "ProcConfig", "ProcStratumFabric", "ProcTransport", "WorkerSupervisor",
    "decode_control", "encode_control", "write_frame",
]
