"""Long-context attention on the PyTorch port: ring attention over a
sequence split across the ranks of a ``torch.distributed`` group.

With the sequence split over ``sp`` ranks, each rank holds S/p of Q, K and
V, and the K/V shards rotate hop by hop around the ring (P2P) with an
online softmax: a rank's peak score memory is S/p x S/p instead of S x S.
``--flash`` runs the hand-written flash kernels on each hop (float32 at
any ``--dim``, as the reference's example); ``--ulysses`` swaps
the ring for all-to-all sequence parallelism; ``--stripe`` balances the
causal ring.

Run N ranks: torchrun --nproc-per-node N examples/torch/long_context.py --seq 32768
(without torchrun it runs at world size 1; ``--device cpu`` uses gloo ranks).
"""

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")
if os.path.isdir(os.path.join(ROOT, "distkeras_tpu_torch")):
    sys.path.insert(0, ROOT)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seq", type=int, default=16384)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--causal", action="store_true")
    ap.add_argument("--flash", action="store_true",
                    help="ring_flash_attention (the flash kernels on each hop)")
    ap.add_argument("--ulysses", action="store_true",
                    help="all-to-all sequence parallelism instead of the K/V ring; "
                         "needs heads %% ranks == 0")
    ap.add_argument("--stripe", action="store_true",
                    help="striped token layout (causal only): every hop does equal work")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.stripe and (args.ulysses or not args.causal):
        ap.error("--stripe balances the CAUSAL ring: needs --causal, without --ulysses")

    import torch

    from distkeras_tpu_torch.parallel import distributed
    from distkeras_tpu_torch.parallel.mesh import make_mesh
    from distkeras_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    distributed.initialize(backend="gloo" if device.type == "cpu" else None)
    p, rank = distributed.process_count(), distributed.process_index()
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh({"sp": p})
    S, H, D = args.seq, args.heads, args.dim
    if S % p:
        ap.error(f"--seq {S} does not split over {p} ranks")
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=(1, S, H, D)).astype(np.float32) for _ in range(3))

    dense_bytes = S * S * H * 4
    ring_bytes = (S // p) ** 2 * H * 4 * p
    if rank == 0:
        print(f"S={S} over sp={p}: dense scores would be {dense_bytes / 1e9:.1f} GB; "
              f"ring peak {ring_bytes / 1e9:.2f} GB across all ranks")

    from distkeras_tpu_torch.ops.ring_flash import stripe_shard

    if args.stripe:
        q, k, v = (np.asarray(stripe_shard(torch.from_numpy(t), p)) for t in (q, k, v))
    cols = slice(rank * (S // p), (rank + 1) * (S // p))  # this rank's shard
    q, k, v = (torch.from_numpy(np.ascontiguousarray(t[:, cols])).to(device)
               for t in (q, k, v))

    t0 = time.time()
    if args.ulysses:
        from distkeras_tpu_torch.ops.ulysses import ulysses_self_attention

        kind = "ulysses"
        out = ulysses_self_attention(q, k, v, mesh, seq_axis="sp", causal=args.causal)
    elif args.flash:
        from distkeras_tpu_torch.ops.ring_flash import ring_flash_attention

        kind = "ring-flash-striped" if args.stripe else "ring-flash"
        out = ring_flash_attention(q, k, v, mesh, seq_axis="sp", causal=args.causal,
                                   stripe=args.stripe)
    else:
        from distkeras_tpu_torch.ops.attention import ring_self_attention

        kind = "ring-striped" if args.stripe else "ring"
        out = ring_self_attention(q, k, v, mesh, seq_axis="sp", causal=args.causal,
                                  stripe=args.stripe)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    finite = bool(torch.isfinite(out).all())
    if rank == 0:
        print(f"{kind} attention done in {time.time() - t0:.1f}s "
              f"out={tuple(out.shape)} per rank, finite={finite}")
    return {"kind": kind, "shape": tuple(out.shape), "finite": finite, "out": out}


if __name__ == "__main__":
    main()
