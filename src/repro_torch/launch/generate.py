"""Batched generation: prefill a batch of prompts, then greedy-decode
with KV or SSM caches updated in place.

    PYTHONPATH=src python -m repro_torch.launch.generate --arch qwen2-7b \
        --batch 4 --prompt-len 512 --gen 32

Runs on the CUDA device unless ``--device cpu`` is given (and fails without
one).  Weights and prompts are random, drawn from ``--seed`` on the device;
``--smoke`` takes the architecture's ``reduced()`` config.  A vlm prompt is
the config's ``n_img_tokens`` patch embeddings followed by ``max(prompt_len
- n_img_tokens, 8)`` text tokens, as the reference builds it.  Prints the
prefill seconds and the decode milliseconds per token.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict

import torch

from .._device import DeviceLike, resolve_device
from ..models.config import ModelConfig
from ..models.frontends import vlm_patch_embeddings
from ..models.sharding import ShardCtx
from ..models.transformer import check_family, init_params
from .steps import make_decode_step, make_prefill_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def grow_cache(cache: Dict[str, Any], n: int) -> Dict[str, Any]:
    """Give the full-attention rows (``k``, ``v``, a hybrid's shared-block
    rows among them) room for ``n`` more positions; ring and SSM caches
    keep their size."""
    out = dict(cache)
    for key in ("k", "v"):
        if key in cache:
            c = cache[key]
            out[key] = torch.cat([c, c.new_zeros(c.shape[:2] + (n,)
                                                 + c.shape[3:])], dim=2)
    return out


def generate(cfg: ModelConfig, *, batch: int, prompt_len: int, gen: int,
             seed: int = 0, device: DeviceLike = None) -> Dict[str, Any]:
    """With random weights (:func:`~repro_torch.models.transformer.
    init_params` from ``seed``), prefill ``batch`` random prompts of
    ``prompt_len`` tokens, then greedily decode ``gen`` tokens (the first
    from the prefill's logits).

    Returns the prompts, the generated tokens ``(batch, gen)``, the prompt
    length used (rounded up to a multiple of a sliding window; for a vlm
    the image embeddings and the text together, ``img_embeds`` beside it),
    the prefill seconds, the decode seconds over ``gen - 1`` steps and, on
    a CUDA device, the peak bytes allocated during the call (weights
    included).
    """
    check_family(cfg)
    device = resolve_device(device)
    if gen < 1 or batch < 1 or prompt_len < 1:
        raise ValueError("batch, prompt_len and gen must be at least 1")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    params = init_params(cfg, seed, device)
    # ring caches need prompt_len % window == 0; round up if needed
    window = cfg.sliding_window if cfg.local_global_period else 0
    if window and prompt_len % window:
        prompt_len += window - prompt_len % window
    gen_rng = torch.Generator(device=device)
    gen_rng.manual_seed(seed)
    img, s_text = None, prompt_len
    if cfg.frontend == "vlm":
        img = vlm_patch_embeddings(gen_rng, batch, cfg.n_img_tokens,
                                   cfg.d_model)
        s_text = max(prompt_len - cfg.n_img_tokens, 8)
        prompt_len = s_text + cfg.n_img_tokens
    prompts = torch.randint(0, cfg.vocab_size, (batch, s_text),
                            generator=gen_rng, device=device)
    ctx = ShardCtx()
    prefill_step = make_prefill_step(cfg, ctx)
    step = make_decode_step(cfg, ctx)
    inputs = {"tokens": prompts}
    if img is not None:
        inputs["img_embeds"] = img

    _sync(device)
    t0 = time.perf_counter()
    last_logits, cache = prefill_step(params, inputs)
    cache = grow_cache(cache, gen)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    tok = torch.argmax(last_logits, dim=-1)[:, None]
    toks = [tok]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        tok, _, cache = step(params, cache, tok, prompt_len + i)
        toks.append(tok)
    tokens = torch.cat(toks, dim=1)
    _sync(device)
    t_decode = time.perf_counter() - t0
    return {
        "prompts": prompts, "img_embeds": img, "tokens": tokens,
        "prompt_len": prompt_len,
        "prefill_s": t_prefill, "decode_s": t_decode,
        "decode_steps": gen - 1,
        "peak_bytes": (torch.cuda.max_memory_allocated(device)
                       if device.type == "cuda" else None),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--smoke", action="store_true",
                    help="the architecture's reduced() config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    from .. import configs
    cfg = configs.get(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    try:
        check_family(cfg)
    except NotImplementedError as e:
        ap.error(str(e))
    res = generate(cfg, batch=args.batch, prompt_len=args.prompt_len,
                   gen=args.gen, seed=args.seed, device=args.device)
    steps = res["decode_steps"]
    print(f"[generate] {cfg.name}: prefill {args.batch}x{res['prompt_len']} "
          f"in {res['prefill_s']:.3f}s; decoded {steps} steps in "
          f"{res['decode_s']:.3f}s "
          f"({res['decode_s'] / max(steps, 1) * 1e3:.2f} ms/tok)")
    print("[generate] sample:", res["tokens"][0, :16].tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
