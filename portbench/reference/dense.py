"""Plain PyTorch reference of the dense decoder (Qwen2: GQA with q/k/v
biases, RoPE on split halves, RMSNorm, SwiGLU), in float32 with TF32 off.

It imports nothing of the program and reads only the benchmark's own
weights (``lib/weights.py``'s tree, bf16, upcast a layer at a time) and
tokens.  One sequence at a time, layer by layer, attention in blocks of
queries, so it fits beside the weights once the program's pools are
freed.

``mm`` is where a lower precision is put in for the control
(:class:`Fp8`): every linear layer's input and weight rounded to
float8 e4m3 with a scale a row (input) and a column (weight)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

Q_BLOCK = 1024


def exact() -> None:
    """float32 matmuls in full float32: no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class F32:
    """Every product in float32."""

    @staticmethod
    def mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return a @ w.float()


class Fp8:
    """The control: each linear layer's operands rounded to float8 e4m3
    (amax scaling, a row of the input and a column of the weight), the
    product of the rounded values in float32."""

    @staticmethod
    def _round(x: torch.Tensor, dim: int) -> torch.Tensor:
        amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
        s = 448.0 / amax
        return (x * s).to(torch.float8_e4m3fn).float() / s

    @classmethod
    def mm(cls, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return cls._round(a, -1) @ cls._round(w.float(), 0)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
        * scale.float()


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate ``x [S, H, D]`` at positions ``pos [S]`` (split halves)."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64,
                                       device=x.device) / d)
    ang = (pos.double()[:, None] * inv)[:, None, :]
    cos, sin = torch.cos(ang).float(), torch.sin(ang).float()
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Causal GQA attention of ``q [S, Hq, D]`` over ``k, v [S, Hkv, D]``,
    queries in blocks."""
    s, hq, d = q.shape
    g = hq // k.shape[1]
    k = k.repeat_interleave(g, dim=1).transpose(0, 1)        # [Hq, S, D]
    v = v.repeat_interleave(g, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    for i in range(0, s, Q_BLOCK):
        qb = q[i:i + Q_BLOCK].transpose(0, 1)                 # [Hq, b, D]
        n = qb.shape[1]
        sc = (qb @ k[:, : i + n].transpose(1, 2)) * d ** -0.5
        mask = torch.ones(n, i + n, dtype=torch.bool, device=q.device)
        mask = mask.tril(diagonal=i)
        sc = sc.masked_fill(~mask, float("-inf"))
        out[i:i + n] = (torch.softmax(sc, -1) @ v[:, : i + n]).transpose(0, 1)
    return out


def swiglu(p: dict, x: torch.Tensor, dims: dict, prec) -> torch.Tensor:
    return prec.mm(F.silu(prec.mm(x, p["w_gate"])) * prec.mm(x, p["w_up"]),
                   p["w_down"])


def layer(p: dict, x: torch.Tensor, pos: torch.Tensor, dims: dict, prec,
          ffn) -> torch.Tensor:
    """One decoder layer of ``x [S, D]`` (float32)."""
    a = p["attn"]
    h = rmsnorm(x, p["ln1"]["scale"], dims["norm_eps"])
    q, k, v = prec.mm(h, a["wq"]), prec.mm(h, a["wk"]), prec.mm(h, a["wv"])
    if "bq" in a:
        q, k, v = q + a["bq"].float(), k + a["bk"].float(), v + a["bv"].float()
    s, hd = x.shape[0], dims["head_dim"]
    q = rope(q.view(s, dims["heads"], hd), pos, dims["rope_theta"])
    k = rope(k.view(s, dims["kv_heads"], hd), pos, dims["rope_theta"])
    v = v.view(s, dims["kv_heads"], hd)
    x = x + prec.mm(attention(q, k, v).reshape(s, -1), a["wo"])
    h = rmsnorm(x, p["ln2"]["scale"], dims["norm_eps"])
    return x + ffn(p["mlp"], h, dims, prec)


def logits_at(params: dict, dims: dict, tokens: torch.Tensor,
              at: torch.Tensor, prec=F32, ffn=swiglu) -> torch.Tensor:
    """float32 logits ``[len(at), V]`` of the sequence ``tokens [S]`` at
    positions ``at`` (each the prediction of the token after it)."""
    pos = torch.arange(tokens.shape[0], device=tokens.device)
    x = params["embed"][tokens.long()].float()
    for p in params["blocks"]:
        x = layer(p, x, pos, dims, prec, ffn)
    h = rmsnorm(x[at], params["ln_f"]["scale"], dims["norm_eps"])
    return prec.mm(h, params["head"])
