"""Train the in-container model that backs the `trained-tiny` quality
tables (counterpart of ``qkv_ecc_tpu/evaluation/experiments/train_tiny.py``,
with its flags and one more, ``--device``):

    python -m qkv_ecc_tpu_torch.evaluation.experiments.train_tiny \
        --steps 4000 --output runs/trained_tiny/checkpoint.npz

trains on the card; ``--device cpu`` trains on the CPU. The checkpoint
(with its config's ``.json``, the word models' ``.vocab.json`` and the
held-out ``.eval_texts.json`` beside it) goes to ``--output``, by default
under the ignored ``runs/`` and never over the tracked checkpoints in
``results/``. Then run the sweep on it:

    QKV_TINY_CHECKPOINT=runs/trained_tiny/checkpoint.npz \
    python -m qkv_ecc_tpu_torch.evaluation.experiments.monte_carlo \
        --model trained-tiny --max-length 256 --output-dir runs/trained_tiny_sweep

Why this exists: the reference's headline result (unprotected INT4 blows up
at BER 1e-2 while ECC-protected caches hold) is invisible on a random-init
model, and this environment cannot download HF checkpoints.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument(
        "--model", default="trained-tiny",
        choices=["trained-tiny", "trained-word", "trained-100m"],
        help="trained-tiny: byte-level; trained-word: 8k word vocab "
        "(enough PPL dynamic range for the catastrophic-INT4 demo); "
        "trained-100m: ~100M-param llama-arch GQA word-level model",
    )
    p.add_argument("--steps", type=int, default=4000)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--seq-len", type=int, default=256)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-corpus-mb", type=int, default=32)
    p.add_argument(
        "--output", default=None,
        help="checkpoint path (.npz); default runs/<model>/checkpoint.npz",
    )
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    if args.output is None:
        args.output = f"runs/{args.model.replace('-', '_')}/checkpoint.npz"

    import numpy as np
    import torch

    from ...device import resolve_device
    from ...models.config import get_model_config
    from ...training import TrainConfig, build_corpus, save_params, train_tiny

    device = resolve_device(args.device)
    cfg = get_model_config(args.model)
    t0 = time.time()
    corpus, eval_texts = build_corpus(max_bytes=args.max_corpus_mb << 20)
    print(
        f"corpus: {len(corpus)/1e6:.1f} MB train, {len(eval_texts)} held-out "
        f"eval texts ({time.time()-t0:.1f}s)",
        file=sys.stderr,
    )
    if args.model in ("trained-word", "trained-100m"):
        from ...training.corpus import WordTokenizer

        text = corpus.decode("utf-8", errors="replace")
        tok = WordTokenizer.train(text, vocab_size=cfg.vocab_size)
        corpus = np.asarray(tok.encode(text), np.int32)
        print(
            f"word tokenizer: vocab {tok.vocab_size}, corpus "
            f"{len(corpus)/1e6:.1f}M tokens ({time.time()-t0:.1f}s)",
            file=sys.stderr,
        )

    tcfg = TrainConfig(
        steps=args.steps, batch=args.batch, seq_len=args.seq_len,
        lr=args.lr, seed=args.seed,
    )
    log = []

    def progress(step, loss, elapsed):
        log.append((step, loss, elapsed))
        print(
            f"  step {step:5d}/{tcfg.steps}  loss {loss:.4f} nats/byte "
            f"(ppl/byte {2.718281828**loss:.2f})  {elapsed:.0f}s",
            file=sys.stderr, flush=True,
        )

    cuda = device.type == "cuda"
    if cuda:  # the training's own peak: above what the process held before it
        torch.cuda.reset_peak_memory_stats(device)
        held = torch.cuda.memory_allocated(device)
    t_train = time.time()
    params, final_loss = train_tiny(cfg, corpus, tcfg, progress, device=device)
    if cuda:
        torch.cuda.synchronize(device)
    seconds = time.time() - t_train
    peak = torch.cuda.max_memory_allocated(device) - held if cuda else None
    print(
        f"trained {tcfg.steps} steps in {seconds:.2f} s on {device}: "
        f"{seconds / tcfg.steps:.4f} s a step, "
        f"{tcfg.steps * tcfg.batch * tcfg.seq_len / seconds:.0f} tokens/s"
        + ("" if peak is None else f", peak memory allocated by the training "
           f"{peak / 1e9:.3f} GB (above {held / 1e9:.3f} GB held before it)"),
        file=sys.stderr,
    )
    save_params(params, args.output, cfg)
    if args.model in ("trained-word", "trained-100m"):
        tok.save(args.output + ".vocab.json")

    # persist the held-out eval texts next to the checkpoint so the sweep
    # evaluates on data the model never trained on
    texts_path = args.output + ".eval_texts.json"
    with open(texts_path, "w") as fh:
        json.dump(eval_texts, fh)
    print(
        f"saved {args.output} (final loss {final_loss:.4f} nats/byte) and "
        f"{texts_path}",
        file=sys.stderr,
    )
    return {"output": args.output, "final_loss": final_loss, "log": log,
            "corpus_tokens": len(corpus), "train_seconds": seconds,
            "peak_memory_bytes": peak}


if __name__ == "__main__":
    main()
