"""Batched serving driver: prefill, then greedy decoding with the model's
KV cache or recurrent state. Twin of ``repro.launch.serve`` with its CLI,
plus ``--device`` (default ``cuda``; raises without a card, never falls
back to the CPU). Serves the ported LM families: the ``dense`` and ``vlm``
decoders (the default, ``qwen3-1.7b``) and RWKV-6 (``ssm``); the others
raise ``NotImplementedError``.

  PYTHONPATH=src python -m repro_torch.launch.serve [--arch qwen3-1.7b] \\
      [--preset full] [--batch 4 --prompt-len 64 --gen 32] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.builder import resolve_device
from repro_torch.models import build_model


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(model, params, prompts, gen: int, device):
    """Prefill ``prompts`` [B, S] (ints, any array type), then ``gen - 1``
    greedy decode steps. An attention cache is padded to ``S + gen`` slots
    after the prefill, as the reference pads it; a recurrent state is the
    decode cache as it is. The argmax runs over the padded vocabulary, as
    the reference's does. Returns ``{"ids": int64 numpy [B, gen], "prefill_s",
    "decode_s", "finite"}``; each time ends in a device synchronize, and
    ``finite`` says every logit of the request was finite."""
    dev = torch.device(device)
    prompts = torch.as_tensor(prompts, dtype=torch.long, device=dev)
    B, S = prompts.shape
    with torch.inference_mode():
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, {"tokens": prompts,
                                               "targets": prompts})
        _sync(dev)
        t_prefill = time.perf_counter() - t0
        if model.kind == "decoder":
            # the decode cache holds prompt + gen slots; the prefill's S
            # keys (fewer under a sliding window) fill its leading slots
            full = model.init_cache(B, S + gen, dev)
            for name, got in cache.items():
                if full[name].shape != got.shape:
                    full[name][:, :, :got.shape[2]] = got
                else:
                    full[name] = got
            cache = full
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
    res = serve(model, params, prompts, args.gen, dev)
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
