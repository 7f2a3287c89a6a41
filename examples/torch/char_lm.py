"""Character-level language model on this repository's own documentation,
on the PyTorch port.

Trains the causal decoder (``gpt_tiny``) on next-character prediction over
README.md and docs/*.md, a text corpus that ships with the repository, then
samples from it with the KV-cache decoder.

Run: python examples/torch/char_lm.py [--epochs 4] [--sample 200] [--device cpu]
"""

import argparse
import glob
import os
import sys
import time

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")
if os.path.isdir(os.path.join(ROOT, "distkeras_tpu_torch")):
    sys.path.insert(0, ROOT)

import distkeras_tpu_torch as dk  # noqa: E402

SEQ = 64


def load_corpus(max_chars: int | None = None) -> tuple[np.ndarray, dict, list]:
    text = ""
    for path in [os.path.join(ROOT, "README.md")] + sorted(
            glob.glob(os.path.join(ROOT, "docs", "*.md"))):
        with open(path, encoding="utf-8") as f:
            text += f.read() + "\n"
    text = text[:max_chars] if max_chars else text
    chars = sorted(set(text))
    stoi = {c: i for i, c in enumerate(chars)}
    ids = np.array([stoi[c] for c in text], np.int32)
    return ids, stoi, chars


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--sample", type=int, default=200)
    ap.add_argument("--stride", type=int, default=8)
    ap.add_argument("--max-chars", type=int, default=None, help="cut the corpus")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    ids, stoi, chars = load_corpus(args.max_chars)
    vocab = len(chars)
    starts = np.arange(0, len(ids) - SEQ - 1, args.stride)
    features = np.stack([ids[s : s + SEQ] for s in starts])
    labels = np.stack([ids[s + 1 : s + SEQ + 1] for s in starts])
    ds = dk.Dataset.from_arrays(features=features, label=labels)
    print(f"corpus: {len(ids)} chars, vocab {vocab}, {len(ds)} windows")

    model = dk.gpt_tiny(seq_len=SEQ, vocab_size=vocab)
    trainer = dk.SingleTrainer(
        model, worker_optimizer="adam", learning_rate=3e-3,
        loss="categorical_crossentropy", batch_size=args.batch_size,
        num_epoch=args.epochs, device=args.device,
    )
    t0 = time.time()
    trained = trainer.train(ds, shuffle=True)
    hist = trainer.get_history()
    print(f"loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f} "
          f"({len(hist)} steps, {time.time() - t0:.1f}s)")

    seed = "The reference "
    prompt = np.asarray([[stoi.get(c, 0) for c in seed]], np.int32)
    n = min(args.sample, SEQ - prompt.shape[1])
    if n < args.sample:
        print(f"note: capping --sample {args.sample} -> {n} "
              f"(trained context {SEQ} - {prompt.shape[1]}-char seed)")
    toks = dk.generate(trained.model, trained.variables, prompt, n,
                       temperature=0.9, top_k=20, seed=0, device=args.device)
    out = seed + "".join(chars[t] for t in toks[0])
    print("sample:", out.replace("\n", "\\n")[:300])
    return {"steps": len(hist), "first": float(hist[0]["loss"]),
            "last": float(hist[-1]["loss"]), "sample": out}


if __name__ == "__main__":
    main()
