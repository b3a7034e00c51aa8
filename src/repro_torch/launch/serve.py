"""Batched serving driver: prefill, then greedy decoding with the model's
KV cache or recurrent state. Twin of ``repro.launch.serve`` with its CLI,
plus ``--device`` (default ``cuda``; raises without a card, never falls
back to the CPU). Serves every LM family in ``configs/``: the ``dense``
and ``vlm`` decoders (the default, ``qwen3-1.7b``), the ``moe`` decoders
(``olmoe-1b-7b``, ``mixtral-8x7b``), RWKV-6 (``ssm``), RecurrentGemma
(``hybrid``) and SeamlessM4T (``encdec``, its encoder fed random stub
frames [B, S // 4, d_model] drawn from the run's generator).

On the CPU, at the smoke preset (the default):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \\
      --device cpu [--batch 4 --prompt-len 64 --gen 32]

On the card, at the published widths:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch \\
      recurrentgemma-9b --preset full
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.builder import resolve_device
from repro_torch.models import build_model
from repro_torch.models.encdec import src_len


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def pad_cache(full, got):
    """The reference's padding after the prefill: each leaf of ``got``
    whose shape differs from ``full``'s fills the leading slots of that
    zero leaf; the others are kept as they are."""
    if isinstance(got, dict):
        return {k: pad_cache(full[k], v) for k, v in got.items()}
    if full.shape == got.shape:
        return got
    full[tuple(slice(0, n) for n in got.shape)] = got
    return full


def serve(model, params, prompts, gen: int, device, frames=None):
    """Prefill ``prompts`` [B, S] (ints, any array type), then ``gen - 1``
    greedy decode steps; an ``encdec`` model needs ``frames`` [B, S // 4,
    d_model], its encoder's input. After the prefill every cache leaf is
    padded to ``init_cache(B, S + gen)`` as the reference pads it: an
    attention cache gets ``S + gen`` slots (the window, if smaller), a
    recurrent state stays as it is, and an encoder memory of ``S // 4``
    slots is padded with zero slots to ``(S + gen) // 4``, which decode
    steps then attend to, as the reference's do. The argmax runs over the
    padded vocabulary, as the reference's does. Returns ``{"ids": int64
    numpy [B, gen], "prefill_s", "decode_s", "finite"}``; each time ends in
    a device synchronize, and ``finite`` says every logit of the request
    was finite."""
    dev = torch.device(device)
    prompts = torch.as_tensor(prompts, dtype=torch.long, device=dev)
    B, S = prompts.shape
    batch = {"tokens": prompts, "targets": prompts}
    if model.kind == "encdec":
        if frames is None:
            raise ValueError("an encdec model needs frames [B, S // 4, D]")
        batch["frames"] = torch.as_tensor(frames, device=dev)
    with torch.inference_mode():
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, batch)
        _sync(dev)
        t_prefill = time.perf_counter() - t0
        cache = pad_cache(model.init_cache(B, S + gen, dev), cache)
        finite = torch.isfinite(logits).all()
        tok = torch.argmax(logits[:, -1], dim=-1)
        out = [tok]
        t0 = time.perf_counter()
        for i in range(gen - 1):
            logits, cache = model.decode_step(
                params, {"token": tok, "pos": S + i}, cache)
            finite &= torch.isfinite(logits).all()
            tok = torch.argmax(logits, dim=-1)
            out.append(tok)
        _sync(dev)
        t_decode = time.perf_counter() - t0
    return {"ids": torch.stack(out, dim=1).cpu().numpy(),
            "prefill_s": t_prefill, "decode_s": t_decode,
            "finite": bool(finite)}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="qwen3-1.7b")
    p.add_argument("--preset", choices=["smoke", "full"], default="smoke")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=64)
    p.add_argument("--gen", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default: cuda; raises without one)")
    args = p.parse_args(argv)

    cfg = (get_smoke_config(args.arch) if args.preset == "smoke"
           else get_config(args.arch))
    model = build_model(cfg)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = model.init(gen, dev)
    B, S = args.batch, args.prompt_len
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                            device=dev)
    frames = None
    if cfg.family == "encdec":
        frames = torch.randn((B, src_len(S), cfg.d_model), generator=gen,
                             device=dev)
    res = serve(model, params, prompts, args.gen, dev, frames)
    t_prefill, t_decode = res["prefill_s"], res["decode_s"]
    ids = res["ids"]
    print(f"arch={cfg.arch_id} batch={B} prompt={S} gen={ids.shape[1]} "
          f"device={dev}")
    print(f"prefill: {t_prefill*1e3:.1f} ms "
          f"({B*S/t_prefill:.0f} tok/s)")
    print(f"decode:  {t_decode*1e3:.1f} ms total, "
          f"{t_decode/max(1,args.gen-1)*1e3:.2f} ms/token/batch "
          f"({B*(args.gen-1)/max(t_decode,1e-9):.0f} tok/s)")
    print("sample generated ids:", ids[0, :12].tolist())
    if not res["finite"]:
        raise RuntimeError("non-finite logits")
    return ids


if __name__ == "__main__":
    main()
