"""Which exchanges a gloo process group runs on CUDA tensors, on one card.

    python3 -m maggy_tpu_torch.parallel.gloo_cuda_probe

Each exchange (``parallel/collectives.py``'s kinds, plus broadcast, the
tensor forms of all-gather and reduce-scatter, and the list form of
reduce-scatter; a ``_bf16`` suffix: the same in bfloat16) runs in a
two-process gloo world of its own on ``cuda:0``, since a gloo exchange of
device memory can kill its process; each rank writes "ok", "wrong values"
or the error it raised. The evidence for the transports ``collectives.py``
picks for each exchange. Needs a CUDA card; imports nothing of JAX.
"""
import json
import multiprocessing as mp
import os
import sys
import tempfile
from datetime import timedelta

OPS = ("all_reduce", "broadcast", "all_gather", "all_to_all", "ring_hop",
       "all_gather_into_tensor", "reduce_scatter_tensor", "reduce_scatter",
       "all_reduce_bf16", "all_gather_into_tensor_bf16", "reduce_scatter_tensor_bf16")


def rank(r, name, path, out):
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(path, 2), rank=r, world_size=2,
                            timeout=timedelta(seconds=30))
    dtype = torch.bfloat16 if name.endswith("_bf16") else torch.float32
    op = name[:-len("_bf16")] if name.endswith("_bf16") else name
    # Small integers: exact in bf16 too.
    x = (torch.arange(1024, device="cuda") % 64 + 100 * r).to(dtype)
    both = torch.arange(1024, device="cuda") % 64 * 2 + 100.0
    try:
        if op == "all_reduce":
            y = x.clone()
            dist.all_reduce(y)
            ok = bool(torch.equal(y.float(), both))
        elif op == "broadcast":
            y = x.clone()
            dist.broadcast(y, 0)
            ok = bool(torch.equal(y.float(), torch.arange(1024, device="cuda") % 64.0))
        elif op == "all_gather":
            parts = [torch.empty_like(x) for _ in range(2)]
            dist.all_gather(parts, x)
            ok = bool(torch.equal(parts[1 - r], x + 100 * (1 - 2 * r)))
        elif op == "all_to_all":
            y = torch.empty_like(x)
            dist.all_to_all_single(y, x)
            # Chunk r of every rank's x, in rank order.
            want = torch.cat([torch.arange(512 * r, 512 * (r + 1), device="cuda") % 64
                              + 100.0 * j for j in range(2)])
            ok = bool(torch.equal(y, want))
        elif op == "all_gather_into_tensor":
            y = torch.empty(2048, device="cuda", dtype=dtype)
            dist.all_gather_into_tensor(y, x)
            ok = bool(torch.equal(y[1024 * (1 - r):1024 * (2 - r)], x + 100 * (1 - 2 * r)))
        elif op in ("reduce_scatter_tensor", "reduce_scatter"):
            y = torch.empty(512, device="cuda", dtype=dtype)
            if op == "reduce_scatter":
                dist.reduce_scatter(y, list(x.chunk(2)))
            else:
                dist.reduce_scatter_tensor(y, x)
            ok = bool(torch.equal(y.float(), both[512 * r:512 * (r + 1)]))
        else:
            recv = torch.empty_like(x)
            for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, 1 - r),
                                               dist.P2POp(dist.irecv, recv, 1 - r)]):
                req.wait()
            ok = bool(torch.equal(recv, x + 100 * (1 - 2 * r)))
        torch.cuda.synchronize()
        res = "ok" if ok else "wrong values"
    except Exception as e:  # noqa: BLE001 - the probe records what gloo raises
        res = "raised {}: {}".format(type(e).__name__, (str(e).splitlines() or [""])[0][:200])
    with open(os.path.join(out, "{}.{}".format(name, r)), "w") as f:
        f.write(res)


if __name__ == "__main__":
    import torch

    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    found = {}
    for op in OPS:
        out = tempfile.mkdtemp()
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=rank, args=(r, op, os.path.join(out, "store"), out))
                 for r in (0, 1)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(90)
            if p.is_alive():
                p.kill()
                p.join()
        found[op] = [open(os.path.join(out, "{}.{}".format(op, r))).read()
                     if os.path.exists(os.path.join(out, "{}.{}".format(op, r)))
                     else "no result, exit code {}".format(procs[r].exitcode) for r in (0, 1)]
        print(op, found[op], flush=True)
    print(json.dumps(found), flush=True)
