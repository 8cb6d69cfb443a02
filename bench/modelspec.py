"""A configuration file's model, in the names the benchmark's own code uses.

The files under ``configs/`` keep the published config's keys (Hugging Face
``config.json`` names), so that they can be held against their source; this
module reads them into one flat ``ModelSpec`` for the plain reference
(``reference/lm.py``) and the FLOP and byte counts (``frozen/flops.py``).

A published key keeps its published value; where the program runs another,
the file's ``assumed`` gives it as ``{"published": ..., "run": ...,
"why": ...}``, and ``run_value`` reads the one that is run.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ModelSpec:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    rope_theta: float
    norm_eps: float
    # multi-head latent attention (DeepSeek-V2); 0 where absent
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # routed experts; 0 where absent
    n_routed: int = 0
    top_k: int = 0
    d_expert_ff: int = 0
    n_shared: int = 0
    first_dense: int = 0
    capacity_factor: float = 0.0
    norm_topk_prob: bool = False
    # the VLM's patch frontend (stub) and its projector; 0 where absent
    frontend_dim: int = 0
    frontend_tokens: int = 0

    @property
    def mla(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def moe(self) -> bool:
        return self.n_routed > 0

    @property
    def qk_dim(self) -> int:
        """Width of a query-key product: ``qk_nope + qk_rope`` under MLA."""
        return (self.qk_nope_head_dim + self.qk_rope_head_dim if self.mla
                else self.head_dim)

    @property
    def v_dim(self) -> int:
        return self.v_head_dim if self.mla else self.head_dim

    @property
    def attn_kv_heads(self) -> int:
        """Key/value heads the attention kernel reads: MLA materialises one
        per query head."""
        return self.n_heads if self.mla else self.n_kv_heads


def run_value(config: dict, key: str, default=None):
    """``key`` as the program runs it: ``assumed[key]["run"]`` where the
    file names a departure, else the published value (``default`` where
    the file has neither)."""
    departure = config.get("assumed", {}).get(key)
    if isinstance(departure, dict) and "run" in departure:
        return departure["run"]
    return config.get(key, default)


def model_spec(config: dict) -> ModelSpec:
    """The ``ModelSpec`` of a configuration file's dict, as it is run."""
    c = {k: run_value(config, k) for k in config}
    c.update({k: v["run"] for k, v in config.get("assumed", {}).items()
              if isinstance(v, dict) and "run" in v})
    if c.get("q_lora_rank"):
        raise ValueError(f"{c['name']}: a low-rank query projection is not "
                         f"in the reference")
    if c.get("rope_scaling"):
        raise ValueError(f"{c['name']}: rope_scaling is not in the reference")
    d, h = c["hidden_size"], c["num_attention_heads"]
    moe = c.get("n_routed_experts") or 0
    return ModelSpec(
        name=c["name"], n_layers=c["num_hidden_layers"], d_model=d,
        n_heads=h, n_kv_heads=c.get("num_key_value_heads", h),
        head_dim=c.get("head_dim") or d // h,
        d_ff=c["intermediate_size"], vocab=c["vocab_size"],
        rope_theta=float(c["rope_theta"]), norm_eps=float(c["rms_norm_eps"]),
        kv_lora_rank=c.get("kv_lora_rank") or 0,
        qk_nope_head_dim=c.get("qk_nope_head_dim") or 0,
        qk_rope_head_dim=c.get("qk_rope_head_dim") or 0,
        v_head_dim=c.get("v_head_dim") or 0,
        n_routed=moe, top_k=c.get("num_experts_per_tok") or 0,
        d_expert_ff=c.get("moe_intermediate_size") or 0,
        n_shared=c.get("n_shared_experts") or 0,
        first_dense=c.get("first_k_dense_replace") or 0,
        capacity_factor=float(c.get("capacity_factor") or 0.0),
        norm_topk_prob=bool(c.get("norm_topk_prob", False)),
        frontend_dim=c.get("vision_hidden_size") or 0,
        frontend_tokens=c.get("num_image_token") or 0)


def layer_kinds(spec: ModelSpec) -> list:
    """Each layer's (parameter prefix, ffn kind), in order: the leading
    dense layers of a routed model are ``dense_layers.i``, the rest
    ``layers.i``."""
    if not spec.moe:
        return [(f"layers.{i}", "mlp") for i in range(spec.n_layers)]
    return ([(f"dense_layers.{i}", "mlp") for i in range(spec.first_dense)]
            + [(f"layers.{i}", "moe")
               for i in range(spec.n_layers - spec.first_dense)])
