"""How the reference's attention init scale conditions a random model
(not collected by pytest; a study behind ROADMAP.md §3's "Reference
caveats" entry on the init).

The reference's ``dense_init`` takes the fan-in of every
three-dimensional leaf from its middle axis, so it draws ``wq`` [d, Hq,
hd] at 1/sqrt(Hq), ``wk`` / ``wv`` at 1/sqrt(Hkv) and ``wo`` at
1/sqrt(hd); the port draws the projections at 1/sqrt(d) and ``wo`` at
1/sqrt(Hq).  At openPangu-7B's widths the reference's scale gives
attention logits of standard deviation ~256, a hard argmax, so a
rounding-sized change anywhere upstream moves the output by whole logit
units.

  PYTHONPATH=src python tests/init_scale_study.py
      openPangu-7B's widths at 4 layers (vocabulary cut to 8192), bf16,
      a 64-token prefill: the largest logit change a relative
      perturbation of 2^-9 (a bf16 half-ulp) of the embeddings causes,
      under the port's scale and under the reference's (CPU, ~1 min).
"""
import dataclasses
import math


def reference_scale(params, cfg):
    """``params`` with every attention leaf rescaled from the port's draw
    to the reference's (the same random bits, other scales)."""
    d, hq = cfg.d_model, cfg.num_heads
    hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    mult = {"wq": math.sqrt(d / hq), "wk": math.sqrt(d / hkv),
            "wv": math.sqrt(d / hkv), "wo": math.sqrt(hq / hd)}

    def walk(tree, in_attn=False):
        return {k: walk(v, in_attn or k in ("attn", "self_attn",
                                            "cross_attn"))
                if isinstance(v, dict) else
                (v * mult[k] if in_attn and k in mult else v)
                for k, v in tree.items()}
    return walk(params)


def perturbation_study():
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T

    torch.set_num_threads(4)
    cfg = dataclasses.replace(get_config("openpangu-7b"), num_layers=4,
                              vocab_size=8192)
    port = T.init_params(torch.Generator().manual_seed(0), cfg,
                         dtype="bfloat16")
    toks = torch.randint(0, cfg.vocab_size, (1, 64), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1))
    lens = torch.tensor([64], dtype=torch.int32)
    embed = T.embed_tokens

    def logits(params, eps):
        def perturbed(p, c, tokens):
            x = embed(p, c, tokens)
            noise = torch.randn(x.shape,
                                generator=torch.Generator().manual_seed(2))
            return (x.float() * (1 + eps * noise)).to(x.dtype)
        T.embed_tokens = perturbed
        try:
            cache = T.init_cache(cfg, 1, 64, device="cpu")
            h, _ = T.prefill(params, cfg, toks, lens, cache)
            return T.unembed(params, cfg, h).float()
        finally:
            T.embed_tokens = embed

    for name, params in (("port", port),
                         ("reference", reference_scale(port, cfg))):
        a, b = logits(params, 0.0), logits(params, 2.0 ** -9)
        print(f"{name} scale: top logit {a.max().item():.4f}; largest "
              f"logit change {(a - b).abs().max().item():.4f}; argmax "
              f"kept {bool(a.argmax() == b.argmax())}")


if __name__ == "__main__":
    perturbation_study()
