"""Train a ~100M-class qwen3-family model on the PyTorch/CUDA port, the
twin of ``examples/train_100m.py``: a few hundred steps on the synthetic
pipeline with async double-buffered checkpoints.  Kill it mid-run and
start it again: it resumes from the last committed checkpoint (the paper's
context-save/resume protocol at training scale).

    PYTHONPATH=src python examples/torch_train_100m.py [--steps 200]
    PYTHONPATH=src python examples/torch_train_100m.py --device cpu --steps 4

The checkpoints go to ``build/train_100m/ck`` unless ``--ckpt`` says
otherwise.
"""
import argparse
import dataclasses
from pathlib import Path

from repro_torch.configs import get_config
from repro_torch.launch.train import train_loop

CKPT = Path(__file__).resolve().parents[1] / "build" / "train_100m" / "ck"


def config():
    """A narrow qwen3 (12 layers, d 512, vocab 8192): 55.6 M params."""
    base = get_config("qwen3-8b")
    return dataclasses.replace(
        base, name="qwen3-100m", n_layers=12, d_model=512, n_heads=8,
        n_kv_heads=4, d_ff=2048, vocab_size=8192, head_dim=64)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt", default=str(CKPT))
    ap.add_argument("--device", default=None,
                    help="cpu runs the plain PyTorch path; default cuda:0")
    args = ap.parse_args(argv)
    cfg = config()
    print(f"[train_100m] {cfg.name}: {cfg.param_count() / 1e6:.1f}M params")
    _, losses = train_loop(cfg, steps=args.steps, batch=8, seq=256,
                           ckpt_base=args.ckpt, ckpt_every=50, lr=6e-4,
                           device=args.device)
    if losses:
        print(f"[train_100m] loss {losses[0]:.3f} -> {losses[-1]:.3f}")


if __name__ == "__main__":
    main()
