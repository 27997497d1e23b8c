"""Training launcher: ``python -m repro_torch.launch.train --arch <id> ...``

Trains a masked-diffusion LM on the synthetic task suite (the band-2
quality testbed) with the port, on the card unless ``--device cpu``; the
flags are the reference's ``repro.launch.train``'s, plus ``--device``.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import TrainConfig, get_config
from repro_torch.data import CharTokenizer, TaskDataset
from repro_torch.training.optimizer import leaves
from repro_torch.training.trainer import train


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llada-8b",
                    help="architecture id (use '<id>-tiny' for reduced)")
    ap.add_argument("--task", default="sum",
                    choices=["sum", "sort", "parity", "bracket", "reverse"])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    tok = CharTokenizer(cfg.vocab_size)
    ds = TaskDataset(args.task, tok)
    tcfg = TrainConfig(batch_size=args.batch, seq_len=ds.seq_len,
                       steps=args.steps, lr=args.lr, seed=args.seed,
                       ckpt_dir=args.ckpt)
    print(f"training {cfg.name} ({cfg.param_count() / 1e6:.1f} M params) "
          f"on task '{args.task}' for {tcfg.steps} steps on {args.device}")
    params, history = train(cfg, tcfg, ds.batches(tcfg.batch_size),
                            device=args.device)
    n = sum(p.numel() for p in leaves(params))
    print(f"final loss {history['loss'][-1]:.4f} aux "
          f"{history['aux'][-1]:.4f} masked-acc {history['acc'][-1]:.3f} "
          f"({n / 1e6:.1f} M params)")



if __name__ == "__main__":
    main()
