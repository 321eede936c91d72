"""LM serving launcher: the port of the reference's ``serve lm`` subcommand
(``repro/launch/serve.py``).

    python -m repro_torch.launch.serve lm --arch rwkv6-1.6b            # cuda:0
    python -m repro_torch.launch.serve lm --arch recurrentgemma-9b --reduced \\
        --device cpu

Draws the model's weights and the prompts from one seeded generator on the
device, prefills the batch, then decodes greedily, and prints the
reference's two ``[serve]`` lines.  It runs on ``cuda:0`` unless asked for
another device; without CUDA and without ``--device cpu`` it raises.  The
reference's other subcommands (task streams, the scheduler, decode
serving) and ``--trace-out`` come with later slices of the port.
"""
from __future__ import annotations

import argparse
import time
import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.shell import resolve_devices
from repro_torch.models import transformer as TF
from repro_torch.models.lm import make_decode_step, make_prefill_step


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def draw(cfg: ModelConfig, *, batch: int, prompt_len: int, seed: int,
         device) -> tuple:
    """The seeded weights and prompts ``serve`` uses: the parameters, then
    ``[batch, prompt_len]`` prompt tokens, from one generator on
    ``device``.  The same arguments give the same draws."""
    g = torch.Generator(device=device).manual_seed(seed)
    params = TF.init_params(cfg, generator=g, device=device)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=g, device=device)
    return params, prompts


def generate(params, prompts: torch.Tensor, cfg: ModelConfig, *,
             gen: int) -> dict:
    """Prefill ``prompts`` [B, T] (query chunks of ``min(64, T)``, as the
    reference's ``serve``), then ``gen - 1`` greedy decode steps.
    Returns ``tokens`` (numpy int32 [B, gen]), the prefill's last-position
    ``logits`` [B, V], and the prefill and decode wall seconds (each read
    back to the host, as the reference's loop does)."""
    device = prompts.device
    prefill = make_prefill_step(cfg, q_chunk=min(64, prompts.shape[1]))
    decode = make_decode_step(cfg)
    _sync(device)
    t0 = time.perf_counter()
    cache, last = prefill(params, {"tokens": prompts})
    tok = torch.argmax(last[:, :cfg.vocab_size], -1).to(torch.int32)[:, None]
    out = [tok.cpu()]
    prefill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        tok, cache = decode(params, cache, tok)
        out.append(tok.cpu())
    decode_s = time.perf_counter() - t0
    return {"tokens": torch.cat(out, dim=1).numpy(), "logits": last,
            "prefill_s": prefill_s, "decode_s": decode_s}


def serve(cfg: ModelConfig, *, batch: int = 4, prompt_len: int = 32,
          gen: int = 16, seed: int = 0, device=None,
          prompts=None) -> np.ndarray:
    """Serve one batch: seeded weights (and prompts, unless ``prompts``
    [batch, prompt_len] are given), prefill, greedy decode.  Returns the
    tokens, numpy int32 [batch, gen]."""
    device = resolve_devices(None if device is None else [device])[0]
    params, drawn = draw(cfg, batch=batch, prompt_len=prompt_len, seed=seed,
                         device=device)
    if prompts is not None:
        prompts = torch.as_tensor(np.asarray(prompts), device=device)
        if tuple(prompts.shape) != (batch, prompt_len):
            raise ValueError(f"prompts {tuple(prompts.shape)} != (batch, "
                             f"prompt_len) = {(batch, prompt_len)}")
    else:
        prompts = drawn
    run = generate(params, prompts, cfg, gen=gen)
    toks = run["tokens"]
    t_prefill, t_decode = run["prefill_s"], run["decode_s"]
    print(f"[serve] prefill {prompt_len} tok x{batch}: {t_prefill:.2f}s; "
          f"decode {gen} tok: {t_decode:.2f}s "
          f"({batch * gen / max(t_decode, 1e-9):.1f} tok/s)")
    print(f"[serve] sample output ids: {toks[0][:12].tolist()}")
    return toks


def main(argv=None):
    ap = argparse.ArgumentParser(prog="serve")
    sub = ap.add_subparsers(dest="cmd", required=True)
    lm = sub.add_parser("lm", help="LM prefill + greedy decode timing")
    lm.add_argument("--arch", default="qwen3-8b")
    lm.add_argument("--reduced", action="store_true")
    lm.add_argument("--batch", type=int, default=4)
    lm.add_argument("--prompt-len", type=int, default=32)
    lm.add_argument("--gen", type=int, default=16)
    lm.add_argument("--seed", type=int, default=0)
    lm.add_argument("--device", default=None,
                    help="torch device (default cuda:0; 'cpu' runs the "
                         "plain PyTorch kernels)")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    serve(cfg, batch=args.batch, prompt_len=args.prompt_len, gen=args.gen,
          seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
