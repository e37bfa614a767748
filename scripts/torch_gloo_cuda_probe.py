#!/usr/bin/env python3
"""Which collectives a process group takes on CUDA tensors when several
processes share one card.

    env PYTHONPATH=. python3 scripts/torch_gloo_cuda_probe.py

Each case runs in two fresh processes on ``cuda:0`` (a ``file://``
store, its own time limit), so a case that crashes or hangs costs only
itself:

- gloo: ``send``/``recv``, ``batch_isend_irecv``, ``all_to_all_single``,
  ``all_reduce``, ``broadcast`` and ``all_gather`` on CUDA tensors, each
  result held against the value the op must give;
- NCCL: two ranks on one card (NCCL refuses a duplicate GPU).

Prints one line per case (``ok``, ``wrong``, ``raised: ...``, ``crashed``
or ``timeout``) and a JSON object of them last. Needs a card; exits 1
without one. ``parallel/collectives.py`` stages through the host exactly
the gloo ops this run finds refused or wrong on CUDA tensors.
"""

import json
import os
import subprocess
import sys
import tempfile

GLOO_CASES = ("send_recv", "batch_isend_irecv", "all_to_all_single", "all_reduce",
              "broadcast", "all_gather")
TIMEOUT_S = 120


def _case(case, backend, store, rank):
    import torch
    import torch.distributed as dist

    dist.init_process_group(backend, init_method=f"file://{store}", world_size=2, rank=rank)
    try:
        dev = torch.device("cuda:0")
        peer = 1 - rank
        x = torch.arange(8, dtype=torch.float32, device=dev) + 100 * rank
        if case == "send_recv":
            got = torch.empty_like(x)
            if rank == 0:
                dist.send(x, peer)
                dist.recv(got, peer)
            else:
                dist.recv(got, peer)
                dist.send(x, peer)
            want = torch.arange(8, dtype=torch.float32, device=dev) + 100 * peer
        elif case == "batch_isend_irecv":
            got = torch.empty_like(x)
            ops = [dist.P2POp(dist.isend, x, peer), dist.P2POp(dist.irecv, got, peer)]
            for work in dist.batch_isend_irecv(ops):
                work.wait()
            want = torch.arange(8, dtype=torch.float32, device=dev) + 100 * peer
        elif case == "all_to_all_single":
            got = torch.empty_like(x)
            dist.all_to_all_single(got, x)
            want = torch.cat([torch.arange(4 * rank, 4 * rank + 4, dtype=torch.float32,
                                           device=dev) + 100 * r for r in range(2)])
        elif case == "all_reduce":
            got = x.clone()
            dist.all_reduce(got)
            want = 2 * torch.arange(8, dtype=torch.float32, device=dev) + 100
        elif case == "broadcast":
            got = x.clone()
            dist.broadcast(got, 0)
            want = torch.arange(8, dtype=torch.float32, device=dev)
        elif case == "all_gather":
            parts = [torch.empty_like(x) for _ in range(2)]
            dist.all_gather(parts, x)
            got = torch.cat(parts)
            want = torch.cat([torch.arange(8, dtype=torch.float32, device=dev) + 100 * r
                              for r in range(2)])
        else:  # nccl: the first collective creates the communicator
            got = x.clone()
            dist.all_reduce(got)
            want = 2 * torch.arange(8, dtype=torch.float32, device=dev) + 100
        torch.cuda.synchronize()
        print("RESULT", "ok" if torch.equal(got, want) else f"wrong: {got.tolist()}",
              flush=True)
    finally:
        dist.destroy_process_group()


def main():
    import torch

    if not torch.cuda.is_available():
        print("torch_gloo_cuda_probe: no CUDA device", file=sys.stderr)
        return 1
    cases = [(c, "gloo") for c in GLOO_CASES] + [("two_ranks_one_card", "nccl")]
    env = {**os.environ, "GLOO_SOCKET_IFNAME": "lo", "NCCL_DEBUG": "WARN"}
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        runs = []
        for case, backend in cases:
            store = os.path.join(tmp, f"{case}.store")
            procs = [subprocess.Popen([sys.executable, __file__, case, backend, store, str(r)],
                                      env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                     for r in range(2)]
            runs.append((f"{backend} {case}", procs))
        for name, procs in runs:
            outs = []
            for p in procs:
                try:
                    outs.append((p.wait(timeout=TIMEOUT_S), p.stdout.read()))
                except subprocess.TimeoutExpired:
                    p.kill()
                    outs.append((None, p.stdout.read()))
            verdicts = []
            for code, text in outs:
                lines = [ln for ln in text.splitlines() if ln.startswith("RESULT ")]
                if code is None:
                    verdicts.append("timeout")
                elif lines:
                    verdicts.append(lines[-1][len("RESULT "):])
                elif code != 0:
                    # NCCL puts its reason on the line after "Last error:".
                    rows = text.splitlines()
                    err = [ln + (" " + rows[i + 1] if ln.endswith("Last error:")
                                 and i + 1 < len(rows) else "")
                           for i, ln in enumerate(rows) if "Error" in ln or "error" in ln]
                    verdicts.append(f"raised: {(err or [f'exit {code}'])[-1][:300]}")
                else:
                    verdicts.append("no result")
            results[name] = verdicts[0] if len(set(verdicts)) == 1 else verdicts
            print(f"{name}: {results[name]}", flush=True)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 5:
        _case(sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4]))
    else:
        sys.exit(main())
