"""Batched serving driver: prefill a batch of prompts, then decode.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
      --batch 4 --prompt-len 16 --gen 16                 # on the GPU
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b --reduce \\
      --device cpu

The reference's ``repro.launch.serve`` with its flags, plus ``--device``
(``cuda`` by default, which raises without a GPU). Weights are the port's
own random initialisation from ``--seed``. Each step runs eagerly: the
reference's ``jax.jit`` of the decode step has no counterpart yet.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.device import resolve_device
from repro_torch.models import build


def sample_token(logits: torch.Tensor, generator: Optional[torch.Generator] = None, *,
                 temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """Greedy (temperature 0) or temperature/top-k sampling through
    ``generator`` (on the logits' device). logits [B,1,V] -> tokens [B,1]."""
    if temperature <= 0.0:
        return torch.argmax(logits[:, -1:], dim=-1)
    x = logits[:, -1, :].float() / temperature
    if top_k:
        kth = torch.sort(x, dim=-1).values[:, -top_k][:, None]
        x = torch.where(x < kth, float("-inf"), x)
    return torch.multinomial(torch.softmax(x, dim=-1), 1, generator=generator)


def against_cpu(arch: str, dev, steps: int = 8, tol: float = 1e-5) -> dict:
    """Reduced ``arch`` (f32) on the CPU and on ``dev`` from the same
    parameters (the port's init on the CPU, copied over) and inputs:
    ``lm_forward``'s logits and ``steps`` decode steps teacher-forced with the
    CPU's greedy tokens. Returns the largest gaps (``forward``, ``decode``),
    each relative to the CPU output's largest magnitude; the greedy tokens
    ``decided`` (the CPU's top-two margin over ``tol`` of the largest
    magnitude) and how many of them are the ``same`` on ``dev``; whether
    ``dev``'s outputs are all ``finite``."""
    from repro_torch.models.common import tree_map

    cfg = reduced(get_config(arch))
    bundle = build(cfg)
    gen = torch.Generator().manual_seed(0)
    params = {"cpu": bundle.init_params(gen, device="cpu")}
    params["dev"] = tree_map(lambda t: t.to(dev), params["cpu"])
    B, S = 2, 16
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=gen)}
    if cfg.is_encdec:
        batch["encoder_frames"] = torch.randn((B, cfg.encoder_seq, cfg.d_model), generator=gen)
    if cfg.n_prefix_embeds:
        batch["prefix_embeds"] = torch.randn((B, cfg.n_prefix_embeds, cfg.d_model),
                                             generator=gen)
    fed, out = [], {}
    with torch.inference_mode():
        for where, d in (("cpu", torch.device("cpu")), ("dev", torch.device(dev))):
            logits = bundle.prefill_step(params[where], {k: v.to(d) for k, v in batch.items()})
            cache = bundle.init_cache(B, steps, device=d)
            tok, dec = batch["tokens"][:, :1], []
            for t in range(steps):
                if where == "cpu":
                    fed.append(tok)
                step, cache = bundle.decode_step(params[where], cache, fed[t].to(d), t)
                dec.append(step.cpu())
                tok = step[:, -1:].argmax(-1).cpu()
            out[where] = (logits.cpu(), dec)

    def rel(a, b):
        return float((a.double() - b.double()).abs().max() / b.abs().max().clamp_min(1e-30))

    (cpu_logits, cpu_dec), (dev_logits, dev_dec) = out["cpu"], out["dev"]
    decided = same = 0
    for g, w in zip(dev_dec, cpu_dec):
        top2 = torch.sort(w[:, -1], dim=-1).values[:, -2:]
        sure = (top2[:, 1] - top2[:, 0]) > tol * w.abs().max()
        decided += int(sure.sum())
        same += int((g[:, -1].argmax(-1) == w[:, -1].argmax(-1))[sure].sum())
    return {"forward": rel(dev_logits, cpu_logits),
            "decode": max(rel(g, w) for g, w in zip(dev_dec, cpu_dec)),
            "decided": decided, "same": same,
            "finite": all(bool(torch.isfinite(t).all()) for t in [dev_logits, *dev_dec])}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduce", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduce:
        cfg = reduced(cfg)
    bundle = build(cfg)
    # the peak while serving, over what the process held before: the
    # parameters, the cache and the steps' temporaries (not init's draws)
    base = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = bundle.init_params(gen, device=dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    B, P, G = args.batch, args.prompt_len, args.gen
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=gen, device=dev)
    cache = bundle.init_cache(B, P + G, device=dev)

    # prefill by teacher-forcing the prompt through the decode path (fills
    # the cache position by position, as the reference does)
    with torch.inference_mode():
        _sync(dev)
        t0 = time.perf_counter()
        logits = None
        for t in range(P):
            logits, cache = bundle.decode_step(params, cache, prompts[:, t:t + 1], t)
        _sync(dev)
        prefill_s = time.perf_counter() - t0

        sample_gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
        out_tokens = []
        tok = sample_token(logits, sample_gen, temperature=args.temperature, top_k=args.top_k)
        t0 = time.perf_counter()
        for g in range(G):
            out_tokens.append(tok)
            logits, cache = bundle.decode_step(params, cache, tok, P + g)
            tok = sample_token(logits, sample_gen, temperature=args.temperature,
                               top_k=args.top_k)
        _sync(dev)
        decode_s = time.perf_counter() - t0

    generated = torch.cat(out_tokens, dim=1)
    tput = B * G / decode_s
    peak = ((torch.cuda.max_memory_allocated(dev) - base) / 2**30 if dev.type == "cuda"
            else None)
    print(f"[serve] {cfg.name} batch={B} prompt={P} gen={G} device={dev}")
    print(f"[serve] prefill {prefill_s * 1e3:.1f} ms; decode {decode_s * 1e3:.1f} ms "
          f"({decode_s * 1e3 / max(G, 1):.3f} ms a step, {tput:.1f} tok/s); peak device "
          + (f"{peak:.3f} GiB while serving" if peak is not None
             else "memory not measured (cpu)"))
    print(f"[serve] sample continuation: {generated[0, :8].tolist()}")
    return {"tokens_per_s": tput, "generated": generated, "prefill_ms": prefill_s * 1e3,
            "decode_ms_per_step": decode_s * 1e3 / max(G, 1), "peak_gib": peak}


if __name__ == "__main__":
    main()
