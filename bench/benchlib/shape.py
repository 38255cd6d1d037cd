"""The sizes of a configuration file, read once, in the names the
benchmark's arithmetic, weights and reference use.

A configuration file keeps its source's keys (a Hugging Face
``config.json``): ``hidden_size``, ``num_hidden_layers``,
``num_attention_heads``, ``num_key_value_heads``, ``head_dim``,
``intermediate_size``, ``vocab_size``, ``rope_theta``, ``rms_norm_eps``,
and for a mixture of experts ``num_local_experts`` and
``num_experts_per_tok``.  The keys the benchmark adds say what the source
leaves to the model's code: ``family`` (``dense`` or ``moe``),
``qk_norm``, ``attn_logit_softcap``, ``capacity_factor`` and ``dtype``.
Where the program's block cannot follow the source, the source's value
stays at the top level and ``as_run`` holds the value that both the
program and the reference run (its reason under ``assumed``)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    family: str
    layers: int
    d: int
    heads: int
    kv_heads: int
    hd: int
    ff: int
    vocab: int
    experts: int = 0
    top_k: int = 0
    qk_norm: bool = False
    theta: float = 10000.0
    eps: float = 1e-6
    softcap: float | None = None
    capacity_factor: float = 1.25
    dtype: str = "bfloat16"

    @classmethod
    def from_config(cls, c: dict) -> "Shape":
        c = {**c, **c.get("as_run", {})}
        return cls(name=c["name"], family=c["family"],
                   layers=int(c["num_hidden_layers"]),
                   d=int(c["hidden_size"]),
                   heads=int(c["num_attention_heads"]),
                   kv_heads=int(c["num_key_value_heads"]),
                   hd=int(c["head_dim"]), ff=int(c["intermediate_size"]),
                   vocab=int(c["vocab_size"]),
                   experts=int(c.get("num_local_experts", 0)),
                   top_k=int(c.get("num_experts_per_tok", 0)),
                   qk_norm=bool(c.get("qk_norm", False)),
                   theta=float(c["rope_theta"]),
                   eps=float(c["rms_norm_eps"]),
                   softcap=c.get("attn_logit_softcap"),
                   capacity_factor=float(c.get("capacity_factor", 1.25)),
                   dtype=c.get("dtype", "bfloat16"))

    def scaled(self, **kw) -> "Shape":
        return dataclasses.replace(self, **kw)

    # -- leaves ------------------------------------------------------------
    def block_leaves(self) -> dict:
        """One layer's leaves → shapes, stored ``(in, out)``."""
        d, hd, f = self.d, self.hd, self.ff
        leaves = {"ln1": (d,), "ln2": (d,), "wq": (d, self.heads * hd),
                  "wk": (d, self.kv_heads * hd),
                  "wv": (d, self.kv_heads * hd),
                  "wo": (self.heads * hd, d)}
        if self.qk_norm:
            leaves.update(qnorm=(hd,), knorm=(hd,))
        if self.experts:
            E = self.experts
            leaves.update(router=(d, E), we_gate=(E, d, f),
                          we_up=(E, d, f), we_down=(E, f, d))
        else:
            leaves.update(w_gate=(d, f), w_up=(d, f), w_down=(f, d))
        return leaves

    def top_leaves(self) -> dict:
        return {"embed": (self.vocab, self.d),
                "unembed": (self.d, self.vocab), "final_norm": (self.d,)}

    # -- parameter counts --------------------------------------------------
    def attn_params(self) -> int:
        return self.d * self.hd * (self.heads + 2 * self.kv_heads) \
            + self.heads * self.hd * self.d

    def ffn_params(self, active: bool) -> int:
        """The FFN's matmul parameters of one layer: every expert, or the
        ``top_k`` a token uses (and the router)."""
        one = 3 * self.d * self.ff
        if not self.experts:
            return one
        return one * (self.top_k if active else self.experts) \
            + self.d * self.experts

    def layer_matmul_params(self, active: bool = True) -> int:
        return self.attn_params() + self.ffn_params(active)
