"""One rank of the multi-process dryrun: a real `torch.distributed` cluster.

Started by `voxtpu_torch.dist.launch_multiprocess_dryrun` as `python -m
voxtpu_torch._dist_worker --process-id R --num-processes N --coordinator
HOST:PORT --local-devices K --device DEV [--backend B]`. Each rank:

1. joins the cluster (`dist.init_distributed`);
2. builds its local (1, K) mesh, DEV listed K times;
3. takes its rows of the files axis, process-major (the files axis spans
   the processes, as voxtpu's design puts it across hosts; each
   recording's frames stay on one process's devices);
4. runs `sharded_analyze` (pitch, Viterbi, formants with the exact carry,
   MFCC, RMS) on voxtpu's dryrun fixture;
5. all-gathers every output over the process group (host copies under
   gloo, device tensors under NCCL), and holds the whole gathered result
   to the per-file serial path computed on this rank alone;
6. prints "multiprocess dryrun ok" with its backend.
"""

from __future__ import annotations

import argparse


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--local-devices", type=int, required=True)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--backend", default=None)
    args = ap.parse_args()

    import torch
    import torch.distributed as tdist

    from voxtpu_torch.device import resolve_device
    from voxtpu_torch.dist import (
        _check_keys, _serial_reference, dryrun_case, init_distributed, make_mesh, sharded_analyze,
    )

    dev = resolve_device(args.device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)  # NCCL's communicator takes the current card
    backend = init_distributed(args.coordinator, args.num_processes, args.process_id, backend=args.backend,
                               device=dev)
    try:
        assert tdist.get_world_size() == args.num_processes, tdist.get_world_size()
        mesh = make_mesh(1, args.local_devices, [dev] * args.local_devices)
        per_rank = 2  # files a rank: each carry must stay within its file
        files, F = per_rank * args.num_processes, args.local_devices * 2
        frames, config = dryrun_case(files, F)
        mine = frames[args.process_id * per_rank : (args.process_id + 1) * per_rank]
        out = sharded_analyze(mine, config, mesh, exact=True)

        home = torch.device("cpu") if backend == "gloo" else dev
        gathered = {}
        for k in sorted(out):
            v = out[k].to(home)
            wire = v.to(torch.uint8) if v.dtype == torch.bool else v
            parts = [torch.empty_like(wire) for _ in range(args.num_processes)]
            tdist.all_gather(parts, wire.contiguous())
            gathered[k] = torch.cat(parts).to(v.dtype).cpu().numpy()
        serial = _serial_reference(frames, config, dev)
        checked = _check_keys(gathered, serial, f"rank {args.process_id}")
        print(f"multiprocess dryrun ok: rank={args.process_id}/{args.num_processes} backend={backend} "
              f"local mesh={mesh.shape} on {dev} x {args.local_devices} global files={files} F={F} "
              f"features_checked={checked}", flush=True)
    finally:
        tdist.destroy_process_group()


if __name__ == "__main__":
    main()
