"""Does ``ProcessGroupNCCL``'s own watchdog see a collective that was
captured into a CUDA graph?

    python3 -m fhpe_tpu_torch.tools.nccl_watchdog_probe [--timeout 5]
        [--spin 20] [--out FILE]

The train steps' all-reduces run inside their captured graphs
(``train/step.py``, ``utils/graph.py``).  NCCL's watchdog thread times out
a collective whose work does not complete within the group's timeout and
tears the process down; this probe asks whether it does so for a replayed
one.  Two child processes, each a one-rank NCCL group on the card with a
``--timeout`` second collective timeout, enqueue a ``--spin`` second
device spin (``torch.cuda._sleep``) and then an average all-reduce behind
it, the same call as the steps' (``ReduceOp.AVG``):

* ``eager``: the all-reduce called as it is, so its work is NCCL's to
  watch;
* ``captured``: the all-reduce captured once into a CUDA graph (after a
  warm-up call on a side stream, as ``CapturedStep`` does), then the
  graph replayed behind the spin.

Each child then sleeps on the host past the spin and synchronizes.
NCCL's watchdog logs ``Watchdog caught collective operation timeout``
for a collective it sees and tears the process down; a child whose
collective it does not see logs nothing and exits 0.  The two children
share the card, so each spin takes longer than ``--spin`` in wall time.
Prints one JSON object with each child's exit code, the seconds from its
enqueue to its synchronize and to its exit, and the watchdog's log line
(also written to ``--out``), the torch and NCCL versions and the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import socket
import subprocess
import sys
import tempfile
import time


def _child(mode: str, timeout: float, spin: float) -> None:
    import torch
    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=timeout),
        device_id=torch.device("cuda", 0))
    x = torch.ones(1024, device="cuda")
    dist.all_reduce(x, op=dist.ReduceOp.AVG)        # the communicator
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(100_000_000)
    end.record()
    end.synchronize()
    cycles = int(spin * 1e8 / (start.elapsed_time(end) / 1e3))
    if mode == "captured":
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            dist.all_reduce(x, op=dist.ReduceOp.AVG)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            dist.all_reduce(x, op=dist.ReduceOp.AVG)
        torch.cuda.synchronize()
    t0 = time.time()
    torch.cuda._sleep(cycles)
    if mode == "captured":
        graph.replay()
    else:
        dist.all_reduce(x, op=dist.ReduceOp.AVG)
    print(f"ENQUEUED {t0!r}", flush=True)
    time.sleep(spin + timeout)
    torch.cuda.synchronize()
    print(f"SYNCED {time.time() - t0:.3f}", flush=True)
    dist.destroy_process_group()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--timeout", type=float, default=5.0)
    ap.add_argument("--spin", type=float, default=20.0)
    ap.add_argument("--out", default="")
    ap.add_argument("--child", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        _child(args.child, args.timeout, args.spin)
        return {}

    import torch
    from ..utils.profiling import card_label
    logs = {mode: tempfile.TemporaryFile("w+") for mode in ("eager",
                                                              "captured")}
    procs = {mode: subprocess.Popen(
        [sys.executable, "-m", "fhpe_tpu_torch.tools.nccl_watchdog_probe",
         "--child", mode, "--timeout", str(args.timeout), "--spin",
         str(args.spin)], stdout=log, stderr=subprocess.STDOUT,
        env=dict(os.environ, TORCH_NCCL_ASYNC_ERROR_HANDLING="3"))
        for mode, log in logs.items()}
    result = {"timeout_s": args.timeout, "spin_s": args.spin,
              "torch": torch.__version__,
              "nccl": ".".join(map(str, torch.cuda.nccl.version())),
              "card": card_label()}
    ends, deadline = {}, time.time() + args.spin * 4 + 120
    while len(ends) < len(procs) and time.time() < deadline:
        for mode, proc in procs.items():
            if mode not in ends and proc.poll() is not None:
                ends[mode] = time.time()
        time.sleep(0.05)
    for mode, proc in procs.items():
        if mode not in ends:
            proc.kill()
            proc.wait()
            ends[mode] = time.time()
        logs[mode].seek(0)
        out = logs[mode].read()
        logs[mode].close()
        lines = out.splitlines()
        enqueued = [float(ln.split()[1]) for ln in lines
                    if ln.startswith("ENQUEUED ")]
        synced = [float(ln.split()[1]) for ln in lines
                  if ln.startswith("SYNCED ")]
        caught = [ln.strip() for ln in lines
                  if "Watchdog caught collective operation timeout" in ln]
        result[mode] = {
            "exit_code": proc.returncode,
            "exit_s_after_enqueue": (round(ends[mode] - enqueued[0], 3)
                                     if enqueued else None),
            "synced_s_after_enqueue": synced[0] if synced else None,
            "watchdog_line": caught[0][:400] if caught else None,
            "tail": out[-1500:] if proc.returncode else ""}
    result["nccl_watchdog_sees_captured"] = bool(
        result["captured"]["watchdog_line"])
    text = json.dumps(result)
    print(text, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return result


if __name__ == "__main__":
    main()
