#!/usr/bin/env python3
"""How far one process moves from itself when its row-parallel sums round
as the model ranks of ``chip_smoke.py``'s Mamba phases round them: the
noise floor under those phases' checks.

    python3 tools/tp_noise_floor.py [ARCH ...]

Runs on one NVIDIA GPU, from the root of a checkout; with model names,
only those models.  Each model as ``tp_train_mamba_on_card`` and
``tp_generate_on_card`` set it up (falcon-mamba-7b at 4 layers on a model
axis of 2, zamba2-7b at 6 layers on one of 4; full width, the same
weights, batches and prompt), in one process, as it is and with its real
blocks' row-parallel products split as ``tp`` model ranks split them:
each product ``a @ w`` summed from ``tp`` blocks of the contraction, each
block's product rounded to bfloat16 and added in bfloat16, as
``collectives.sum_over`` adds the ranks' partials (Mamba1's ``x_proj``
and ``out_proj``; Mamba2's ``out_proj``; the hybrid's shared attention
``wo`` and MLP ``down``), and Mamba2's gated norm with its statistic
summed from ``tp`` blocks (``mamba.split_gated_norm``, in plain torch as
the ranks run it, in place of the ``rmsnorm`` kernel).  The weights are
wrapped where a block reads them (:class:`RowBlocks`); the blocks' code
is the program's own.  Not split: the cotangents of the column-parallel
products, which the ranks sum in the backward too.

Training (``TPMB_STEPS`` steps of ``make_train_step``): each leaf's
update and AdamW first moment against the plain run's, relative in
Frobenius norm, as ``chip_smoke.param_readings`` reads the ranks'.
Generation (prefill and ``TPG_TOKENS - 1`` decode steps, teacher-forced
on the plain run's greedy tokens): the logits' largest and mean absolute
difference from the plain run's, by step, and the greedy tokens that
differ with the plain run's margin at each.  One JSON line a model and
path, then ``nvidia-smi``'s name and power limit of the card.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.models import mamba as MB  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ARCHS = ("falcon-mamba-7b", "zamba2-7b")
#: the leaves whose products the ranks sum over the model axis
ROW_PARALLEL = ("x_proj", "out_proj", "wo", "down")


#: what ``a @ w`` reaches ``__torch_function__`` as
_MATMUL = (torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__)


class RowBlocks(torch.Tensor):
    """A weight ``w`` whose products ``a @ w`` are summed from ``parts``
    blocks of the contraction, each rounded to the product's type: what
    ``parts`` model ranks compute and ``sum_over`` adds.  Its views
    (``reshape``, a row of a stack) keep the rule; every other result is
    a plain tensor."""
    parts = 1

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _MATMUL and isinstance(args[1], cls) \
                and not isinstance(args[0], RowBlocks):
            a, w = args[0], args[1].as_subclass(torch.Tensor)
            k = w.shape[0] // cls.parts
            out = a[..., :k] @ w[:k]
            for i in range(1, cls.parts):
                out = out + a[..., i * k:(i + 1) * k] @ w[i * k:(i + 1) * k]
            return out
        out = super().__torch_function__(func, types, args, kwargs)
        if func in (torch.Tensor.reshape, torch.Tensor.view,
                    torch.Tensor.__getitem__):
            return out
        if isinstance(out, RowBlocks):
            return out.as_subclass(torch.Tensor)
        return out


@functools.lru_cache(maxsize=None)
def row_blocks(parts: int) -> type:
    """The :class:`RowBlocks` of ``parts`` blocks."""
    return type(f"RowBlocks{parts}", (RowBlocks,), {"parts": parts})


def _wrap(p: dict, parts: int) -> dict:
    """A layer's leaves with its row-parallel ones split in ``parts``."""
    cls = row_blocks(parts)
    return {k: v.as_subclass(cls) if k in ROW_PARALLEL else v
            for k, v in p.items()}


def _split_norm(parts: int):
    """Mamba2's gated norm with its statistic summed from ``parts``
    blocks of the channels (``split_gated_norm``)."""
    def norm(g, w, eps):
        dl = g.shape[-1] // parts
        blocks = torch.stack(g.split(dl, -1))
        out = MB.split_gated_norm(
            blocks, w.view((parts,) + (1,) * (g.dim() - 1) + (dl,)),
            g.shape[-1], eps, lambda t: t.sum(0, keepdim=True))
        return torch.cat(list(out), -1).to(g.dtype)
    return norm


@contextlib.contextmanager
def split_sums(parts: int):
    """The real Mamba blocks, the hybrid's shared block and the decode
    step's attention layers with their row-parallel products split in
    ``parts`` (and Mamba2's gated norm split), for the ``with`` body."""
    blocks, shared, body = dict(MB.BLOCKS), T.shared_attn_apply, \
        M._decode_layer_body
    real_norm = MB.rms_norm

    def mamba(kind):
        def block(x, p, cfg, **kw):
            if kind == "mamba2":
                MB.rms_norm = _split_norm(parts)
            try:
                return blocks[kind](x, _wrap(p, parts), cfg, **kw)
            finally:
                MB.rms_norm = real_norm
        return block

    def shared_apply(x, pending, sp, *rest):
        return shared(x, pending, _wrap(sp, parts), *rest)

    def decode_body(x, pending, lp, *rest, **kw):
        return body(x, pending, _wrap(lp, parts), *rest, **kw)
    MB.BLOCKS.update({k: mamba(k) for k in blocks})
    T.shared_attn_apply, M._decode_layer_body = shared_apply, decode_body
    try:
        yield
    finally:
        MB.BLOCKS.update(blocks)
        T.shared_attn_apply, M._decode_layer_body = shared, body
        MB.rms_norm = real_norm


def training(arch: str, device) -> dict:
    """The training run's readings against the plain one."""
    cfg, mesh, _, n_micro, batches = cs._tpmb_setup(arch,
                                                    cs.TPMB_CASES[arch])
    parts = mesh.shape["model"]

    def run():
        return cs._one_process_run(cfg, batches, device, n_micro,
                                   cs.TRAIN_LR)
    base = run()
    with split_sums(parts):
        got = run()
    names = cs.leaf_names(base[1])
    rows = {}
    for tree, i in (("update", 1), ("moment", 2)):
        rows[tree] = {}
        for name, a, b, b0 in zip(names, cs._tree.leaves(got[i]),
                                  cs._tree.leaves(base[i]),
                                  cs._tree.leaves(base[0])):
            w = b.float() - (b0.float() if i == 1 else 0)
            rows[tree][name] = float((a.float() - b.float()).norm()
                                     / max(float(w.norm()), 1e-30))
    losses, plain_losses = got[3], base[3]
    del got, base
    torch.cuda.empty_cache()
    return {"parts": parts, "losses": losses, "plain_losses": plain_losses,
            "rel_err": rows,
            "max_update_rel_err": max(rows["update"].values()),
            "max_moment_rel_err": max(rows["moment"].values())}


def generation(arch: str, device) -> dict:
    """The teacher-forced generation's logit differences and the greedy
    tokens' margins against the plain run."""
    cfg, mesh, _, prompt = cs._tpg_setup(arch, cs.TPG_CASES[arch])
    parts = mesh.shape["model"]
    plain = cs._one_process_generate(cfg, prompt, device)
    toks = plain["tokens"]
    params = cs.init_params(cfg, seed=0, device=device)
    ctx = cs.ShardCtx()
    with split_sums(parts), torch.no_grad():
        lg, cache = M.prefill(params, cfg, ctx,
                              torch.as_tensor(prompt, device=device))
        cache = cs.gen_cli.grow_cache(cache, cs.TPG_TOKENS)
        out = [lg]
        for j in range(cs.TPG_TOKENS - 1):
            lg, cache = M.decode_step(params, cfg, ctx, toks[:, j:j + 1],
                                      cache, cs.TPG_PROMPT + j)
            out.append(lg)
    want = [plain["prefill"]] + list(plain["steps"])
    d = [(a.float() - b.float()).abs() for a, b in zip(out, want)]
    greedy = torch.stack([t.argmax(-1) for t in out], 1)
    margins = []
    for i, j in torch.nonzero(greedy != toks).tolist():
        row = want[j][i].float()
        margins.append(float(row.max() - row[greedy[i, j]]))
    return {"parts": parts,
            "max_abs_by_step": [float(t.max()) for t in d],
            "max_abs": max(float(t.max()) for t in d),
            "mean_abs": float(sum(t.sum() for t in d)
                              / sum(t.numel() for t in d)),
            "tokens_equal": int((greedy == toks).sum()),
            "tokens": int(toks.numel()), "token_margins": margins}


def main() -> int:
    if not torch.cuda.is_available():
        print("tp_noise_floor: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    cs._build.build()
    cs._build.load_library()
    device = torch.device("cuda")
    for arch in sys.argv[1:] or ARCHS:
        print(json.dumps({"model": arch, "training": training(arch, device)}),
              flush=True)
        print(json.dumps({"model": arch,
                          "generation": generation(arch, device)}),
              flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
