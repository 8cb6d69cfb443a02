"""Plain float32 reference of the served models, and the seeded weights that
the benchmark hands to both sides.

Plain PyTorch only: it imports nothing of the program.  It follows the
configuration file (``modelspec.ModelSpec``) and the published description
of each block, with the departures the configuration names (see PERF.md):

- pre-norm RMSNorm (``rms_norm_eps``), split-half RoPE on every query and
  key width that rotates (a fixed permutation of DeepSeek's interleaved
  pairs, which random weights cannot tell apart), causal softmax attention
  scaled by ``1/sqrt(q.k width)``, query head ``h`` reading key/value head
  ``h // (heads / kv heads)``;
- MLA (DeepSeek-V2, no query low-rank): ``wkv_a`` to the latent and one
  shared rope key, the latent normed, ``wkv_b`` to per-head k_nope and v;
- SwiGLU MLPs; the routed layer: softmax router, the top k (the lower
  expert first among equal gates; or the experts another run chose, in
  its slot order, where the reference follows that routing), their gates
  renormalised where ``norm_topk_prob``,
  each expert's capacity ``max(ceil(k * T * capacity_factor / E), 1)`` over
  the T tokens dispatched together, an assignment arriving (row-major over
  tokens and slots) at or past it dropped, then the shared experts;
- the VLM's patch projector ``fc2(gelu_tanh(fc1(x)))``, its tokens ahead of
  the text's.

Weights: every parameter is drawn in bfloat16, the type the program serves,
from a generator on the device seeded by the run's seed and the parameter's
group (a layer, the embedding, the head, the projector), one draw per group;
matrices are scaled by ``1/sqrt(fan_in)``, the embedding and biases by 0.02,
norm scales are ones.  So the reference can draw one layer again while the
program's copy is gone.  The names are the program's parameter names, which
the harness checks against the program's model before it hands them over.

``forward(..., quant="fp8")`` is the control: each product's weight (per
output column) and input (per row) rounded to float8 e4m3 with an absmax
scale, the precision below the configuration's bfloat16.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from modelspec import ModelSpec, layer_kinds

DTYPE = torch.bfloat16   # the type the weights are served in
FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0


# ---------------------------------------------------------------- weights
def _attention_entries(s: ModelSpec, p: str) -> list:
    d, h = s.d_model, s.n_heads
    if s.mla:
        r, dr = s.kv_lora_rank, s.qk_rope_head_dim
        return [(f"{p}.attn.wq.w", (d, h * s.qk_dim), d),
                (f"{p}.attn.wkv_a.w", (d, r + dr), d),
                (f"{p}.attn.kv_a_norm.scale", (r,), None),
                (f"{p}.attn.wkv_b.w",
                 (r, h * (s.qk_nope_head_dim + s.v_head_dim)), r),
                (f"{p}.attn.wo.w", (h * s.v_head_dim, d), h * s.v_head_dim)]
    hd, kv = s.head_dim, s.n_kv_heads
    return [(f"{p}.attn.wq.w", (d, h * hd), d),
            (f"{p}.attn.wk.w", (d, kv * hd), d),
            (f"{p}.attn.wv.w", (d, kv * hd), d),
            (f"{p}.attn.wo.w", (h * hd, d), h * hd)]


def _mlp_entries(p: str, d: int, ff: int) -> list:
    return [(f"{p}.gate.w", (d, ff), d), (f"{p}.up.w", (d, ff), d),
            (f"{p}.down.w", (ff, d), ff)]


def layout(s: ModelSpec) -> list:
    """[(group, [(parameter name, shape, fan_in | None for ones | 0 for a
    0.02 scale)])]: every parameter of the model, by draw group."""
    d = s.d_model
    groups = [("embed", [("embed.table", (s.vocab, d), 0)])]
    for p, kind in layer_kinds(s):
        entries = [(f"{p}.ln1.scale", (d,), None)]
        entries += _attention_entries(s, p)
        entries.append((f"{p}.ln2.scale", (d,), None))
        if kind == "mlp":
            entries += _mlp_entries(f"{p}.mlp", d, s.d_ff)
        else:
            e, ff = s.n_routed, s.d_expert_ff
            entries += [(f"{p}.moe.router.w", (d, e), d),
                        (f"{p}.moe.w_gate", (e, d, ff), d),
                        (f"{p}.moe.w_up", (e, d, ff), d),
                        (f"{p}.moe.w_down", (e, ff, d), ff)]
            if s.n_shared:
                entries += _mlp_entries(f"{p}.moe.shared", d,
                                        s.n_shared * ff)
        groups.append((p, entries))
    groups.append(("head", [("final_norm.scale", (d,), None),
                            ("lm_head.w", (d, s.vocab), d)]))
    if s.frontend_dim:
        fd = s.frontend_dim
        groups.append(("projector", [("projector.fc1.w", (fd, d), fd),
                                     ("projector.fc1.b", (d,), 0),
                                     ("projector.fc2.w", (d, d), d),
                                     ("projector.fc2.b", (d,), 0)]))
    return groups


def group_seed(seed: int, index: int) -> int:
    return (int(seed) * 1_000_003 + index) % (2 ** 63 - 1)


def draw_group(seed: int, index: int, entries, device) -> dict:
    """The group's parameters in ``DTYPE`` on ``device``: one normal draw
    for all of its matrices (views of it), scaled in place."""
    n = sum(math.prod(shape) for _, shape, fan in entries if fan is not None)
    gen = torch.Generator(device=device)
    gen.manual_seed(group_seed(seed, index))
    flat = torch.empty(n, dtype=DTYPE, device=device)
    flat.normal_(generator=gen)
    out, off = {}, 0
    for name, shape, fan in entries:
        if fan is None:
            out[name] = torch.ones(shape, dtype=DTYPE, device=device)
            continue
        k = math.prod(shape)
        t = flat[off:off + k].view(shape)
        t.mul_(0.02 if fan == 0 else 1.0 / math.sqrt(fan))
        out[name] = t
        off += k
    return out


class Weights:
    """The seeded weights of one model, drawn a group at a time."""

    def __init__(self, spec: ModelSpec, seed: int, device):
        self.spec, self.seed, self.device = spec, int(seed), device
        self.groups = layout(spec)
        self._index = {name: i for i, (name, _) in enumerate(self.groups)}

    def draw(self, group: str) -> dict:
        i = self._index[group]
        return draw_group(self.seed, i, self.groups[i][1], self.device)

    def f32(self, group: str) -> dict:
        return {k: v.float() for k, v in self.draw(group).items()}


# ---------------------------------------------------------------- blocks
def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with an absmax scale along ``dim``."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / FP8_MAX
    return (x / scale).to(FP8).float() * scale


class _Math:
    def __init__(self, spec: ModelSpec, quant: Optional[str]):
        if quant not in (None, "fp8"):
            raise ValueError(f"unknown control precision {quant!r}")
        self.s, self.quant = spec, quant

    def lin(self, x, w, b=None):
        if self.quant:
            x = _fp8(x, -1)
            w = _fp8(w, -2)
        y = x @ w
        return y if b is None else y + b

    def rms(self, x, scale):
        var = (x * x).mean(-1, keepdim=True)
        return x * torch.rsqrt(var + self.s.norm_eps) * scale

    def rope(self, x, positions):
        """x [B, S, H, D], split-half rotation."""
        d = x.shape[-1]
        half = d // 2
        exps = torch.arange(0, half, dtype=torch.float64,
                            device=x.device) / half
        inv = (1.0 / (self.s.rope_theta ** exps)).float()
        ang = positions[:, None].float() * inv
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)

    @staticmethod
    def attend(q, k, v):
        """Causal attention, one batch row at a time: q [B,S,H,Dq], k
        [B,S,KV,Dq], v [B,S,KV,Dv] -> [B,S,H*Dv]."""
        B, S, H, dq = q.shape
        g = H // k.shape[2]
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        out = []
        for b in range(B):
            qb = q[b].transpose(0, 1)
            kb = k[b].transpose(0, 1).repeat_interleave(g, 0)
            vb = v[b].transpose(0, 1).repeat_interleave(g, 0)
            sc = (qb @ kb.transpose(1, 2)) / math.sqrt(dq)
            sc = sc.masked_fill(~mask, float("-inf"))
            o = torch.softmax(sc, -1) @ vb           # [H, S, Dv]
            out.append(o.transpose(0, 1).reshape(S, -1))
        return torch.stack(out)

    def attention(self, w, p, x, positions, on_latent=None, layer=0):
        s = self.s
        B, S, _ = x.shape
        if s.mla:
            h, dn, dr, r = (s.n_heads, s.qk_nope_head_dim,
                            s.qk_rope_head_dim, s.kv_lora_rank)
            q = self.lin(x, w[f"{p}.attn.wq.w"]).view(B, S, h, dn + dr)
            q = torch.cat([q[..., :dn], self.rope(q[..., dn:], positions)],
                          -1)
            kv_a = self.lin(x, w[f"{p}.attn.wkv_a.w"])
            c_kv = self.rms(kv_a[..., :r], w[f"{p}.attn.kv_a_norm.scale"])
            k_rope = self.rope(kv_a[..., r:][:, :, None, :], positions)
            if on_latent is not None:
                on_latent(layer, c_kv, k_rope[:, :, 0])
            kvb = self.lin(c_kv, w[f"{p}.attn.wkv_b.w"]).view(
                B, S, h, dn + s.v_head_dim)
            k = torch.cat([kvb[..., :dn], k_rope.expand(B, S, h, dr)], -1)
            o = self.attend(q, k, kvb[..., dn:])
        else:
            h, kv, hd = s.n_heads, s.n_kv_heads, s.head_dim
            q = self.lin(x, w[f"{p}.attn.wq.w"]).view(B, S, h, hd)
            k = self.lin(x, w[f"{p}.attn.wk.w"]).view(B, S, kv, hd)
            v = self.lin(x, w[f"{p}.attn.wv.w"]).view(B, S, kv, hd)
            o = self.attend(self.rope(q, positions), self.rope(k, positions),
                            v)
        return self.lin(o, w[f"{p}.attn.wo.w"])

    def mlp(self, w, p, x):
        g = self.lin(x, w[f"{p}.gate.w"])
        return self.lin(torch.nn.functional.silu(g) * self.lin(
            x, w[f"{p}.up.w"]), w[f"{p}.down.w"])

    def moe(self, w, p, x, groups, picks=None, on_route=None, layer=0):
        """x [B, S, d]; ``groups``: index tensors into the B*S tokens
        (row-major), each a set dispatched together, in arrival order;
        ``picks``: each group's chosen experts [n, k] in slot order, where
        the routing followed is another's (default: this router's own top
        k); ``on_route(layer, group, router logits [n, E], picks)``."""
        s = self.s
        B, S, d = x.shape
        xt = x.reshape(B * S, d)
        logits = self.lin(xt, w[f"{p}.moe.router.w"])
        gates = torch.softmax(logits, -1)
        own = torch.sort(gates, dim=-1, descending=True,
                         stable=True)[1][:, :s.top_k]
        out = torch.zeros_like(xt)
        wg, wu, wd = (w[f"{p}.moe.{n}"] for n in ("w_gate", "w_up",
                                                   "w_down"))
        for g, grp in enumerate(groups):
            gi = own[grp] if picks is None else picks[g].to(x.device).long()
            if on_route is not None:
                on_route(layer, g, logits[grp], gi)
            vals = gates[grp].gather(1, gi)
            if s.norm_topk_prob:
                vals = vals / vals.sum(-1, keepdim=True).clamp(min=1e-9)
            n, k = gi.shape
            cap = max(math.ceil(k * n * s.capacity_factor / s.n_routed), 1)
            flat = gi.reshape(-1)
            onehot = torch.nn.functional.one_hot(flat, s.n_routed)
            pos = (onehot.cumsum(0) - 1).gather(1, flat[:, None])[:, 0]
            keep = pos < cap
            tok = grp.repeat_interleave(k)
            wt = vals.reshape(-1)
            for e in range(s.n_routed):
                sel = keep & (flat == e)
                if not bool(sel.any()):
                    continue
                rows = tok[sel]
                xe = xt[rows]
                he = torch.nn.functional.silu(self.lin(xe, wg[e])) * \
                    self.lin(xe, wu[e])
                out.index_add_(0, rows, self.lin(he, wd[e]) * wt[sel, None])
        out = out.view(B, S, d)
        if s.n_shared:
            out = out + self.mlp(w, f"{p}.moe.shared", x)
        return out


@torch.no_grad()
def forward(spec: ModelSpec, weights: Weights, tokens: torch.Tensor, *,
            logit_positions, patch_embeds: Optional[torch.Tensor] = None,
            routing_groups=None, quant: Optional[str] = None,
            routing=None, on_latent: Optional[Callable] = None,
            on_route: Optional[Callable] = None) -> torch.Tensor:
    """Logits [B, len(logit_positions), V] (f32) of ``tokens`` [B, S_text]
    led by the projected ``patch_embeds`` [B, n_img, frontend_dim] where
    given; positions count the image tokens.  ``routing_groups``: as
    ``_Math.moe`` (default: all tokens together).  ``routing``: for each
    routed layer, each group's chosen experts, where the reference follows
    another's routing (default: its own).  ``on_latent(layer, c_kv,
    k_rope)`` sees each MLA layer's normed latent and rotated key,
    ``on_route`` each routed layer's choices (``_Math.moe``)."""
    m = _Math(spec, quant)
    dev = tokens.device
    h = weights.f32("embed")["embed.table"][tokens]
    if patch_embeds is not None:
        pw = weights.f32("projector")
        pe = m.lin(patch_embeds.float(), pw["projector.fc1.w"],
                   pw["projector.fc1.b"])
        pe = torch.nn.functional.gelu(pe, approximate="tanh")
        pe = m.lin(pe, pw["projector.fc2.w"], pw["projector.fc2.b"])
        h = torch.cat([pe, h], 1)
    B, S, _ = h.shape
    positions = torch.arange(S, device=dev)
    if routing_groups is None:
        routing_groups = [torch.arange(B * S, device=dev)]
    n_moe = 0
    for layer, (p, kind) in enumerate(layer_kinds(spec)):
        w = weights.f32(p)
        h = h + m.attention(w, p, m.rms(h, w[f"{p}.ln1.scale"]), positions,
                            on_latent, layer)
        x = m.rms(h, w[f"{p}.ln2.scale"])
        if kind == "mlp":
            h = h + m.mlp(w, f"{p}.mlp", x)
        else:
            h = h + m.moe(w, p, x, routing_groups,
                          None if routing is None else routing[n_moe],
                          on_route, n_moe)
            n_moe += 1
        del w
    head = weights.f32("head")
    pos = torch.as_tensor(list(logit_positions), device=dev)
    x = m.rms(h[:, pos], head["final_norm.scale"])
    return m.lin(x, head["lm_head.w"])
