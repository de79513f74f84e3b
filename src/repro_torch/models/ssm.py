"""Mamba2 SSD mixer — chunked state-space-duality algorithm (arXiv:2405.21060),
as the reference's ``repro.models.ssm`` computes it.

The SSD recurrence per head (scalar-a, state N, head dim P):
    h_t = a_t * h_{t-1} + dt_t * (B_t ⊗ x_t)        h in R^{P x N}
    y_t = C_t · h_t + D * x_t

Chunked form (chunk length Lc):
  * intra-chunk: quadratic "attention-like" term  L ⊙ (C B^T) @ (dt·x)
  * chunk states: per-chunk summary  S_c = Σ_j decay_j B_j ⊗ (dt x)_j
  * inter-chunk: a short sequential loop over the n_chunks states
  * output correction: y += decay_i * C_i · h_{c-1}

Decode is the O(1) recurrence on a carried [B, H, P, N] state.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init, rmsnorm, silu

__all__ = ["init_mamba", "mamba_block", "init_mamba_cache", "softplus", "ssd_chunked",
           "ssd_reference"]


def _dims(cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    P = cfg.ssm_head_dim
    H = d_in // P
    N = cfg.ssm_state
    return d_in, H, P, N


def init_mamba(gen: torch.Generator, cfg, dtype, device) -> dict:
    d = cfg.d_model
    d_in, H, P, N = _dims(cfg)
    kw = dict(dtype=dtype, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    W = cfg.conv_width
    return {
        "in_proj_z": dense_init(gen, (d, d_in), **kw),
        "in_proj_x": dense_init(gen, (d, d_in), **kw),
        "in_proj_B": dense_init(gen, (d, N), **kw),
        "in_proj_C": dense_init(gen, (d, N), **kw),
        "in_proj_dt": dense_init(gen, (d, H), **kw),
        "conv": {"wx": dense_init(gen, (W, d_in), **kw),
                 "bx": torch.zeros((d_in,), **kw),
                 "wB": dense_init(gen, (W, N), **kw),
                 "bB": torch.zeros((N,), **kw),
                 "wC": dense_init(gen, (W, N), **kw),
                 "bC": torch.zeros((N,), **kw)},
        "A_log": torch.zeros((H,), **f32),          # a = exp(-softplus(A_log)*dt)
        "dt_bias": torch.full((H,), -4.6, **f32),   # softplus^-1(0.01)-ish
        "D": torch.ones((H,), **f32),
        "out_proj": dense_init(gen, (d_in, d),
                               scale=1.0 / math.sqrt(d_in * 2.0 * max(cfg.n_layers, 1)), **kw),
        "norm_scale": torch.zeros((d_in,), **kw),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, x.new_zeros(()))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv. x [B,S,C]; w [W,C]. Returns (y, new_state):
    the last W - 1 inputs, the carried context of the next call."""
    W = w.shape[0]
    if state is None:
        ctx = F.pad(x, (0, 0, W - 1, 0))
    else:
        ctx = torch.cat([state.to(x.dtype), x], dim=1)
    S = x.shape[1]
    y = ctx[:, 0:S, :] * w[0][None, None, :]
    for i in range(1, W):
        y = y + ctx[:, i:i + S, :] * w[i][None, None, :]
    new_state = ctx[:, -(W - 1):, :] if W > 1 else x[:, :0]
    return silu(y + b[None, None, :]), new_state


def ssd_reference(xdt, a, Bm, Cm):
    """Naive sequential SSD (oracle for tests). xdt [B,S,H,P]; a [B,S,H];
    Bm/Cm [B,S,N]. Returns y [B,S,H,P]."""
    Bsz, S, H, P = xdt.shape
    N = Bm.shape[-1]
    h = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=xdt.device)
    xdt, a, Bm, Cm = xdt.float(), a.float(), Bm.float(), Cm.float()
    ys = []
    for t in range(S):
        h = a[:, t, :, None, None] * h + xdt[:, t, :, :, None] * Bm[:, t, None, None, :]
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cm[:, t]))
    return torch.stack(ys, dim=1)


def ssd_chunked(xdt, a, Bm, Cm, chunk: int, h_init: Optional[torch.Tensor] = None):
    """Chunked SSD. Shapes as ssd_reference. Returns (y, h_final). A
    padded final chunk carries a = 1 (no decay) and zero inputs."""
    Bsz, S, H, P = xdt.shape
    N = Bm.shape[-1]
    Lc = min(chunk, S)
    pad = (-S) % Lc
    if pad:
        xdt = F.pad(xdt, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad), value=1.0)
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    nC = (S + pad) // Lc
    dev = xdt.device
    xc = xdt.reshape(Bsz, nC, Lc, H, P).float()
    ac = a.reshape(Bsz, nC, Lc, H).float()
    bc = Bm.reshape(Bsz, nC, Lc, N).float()
    cc = Cm.reshape(Bsz, nC, Lc, N).float()

    la = torch.cumsum(torch.log(torch.clamp(ac, min=1e-30)), dim=2)   # [B,nC,Lc,H]
    # intra-chunk: scores[i,j] = exp(la_i - la_j) * (C_i · B_j), j <= i
    seg = la[:, :, :, None, :] - la[:, :, None, :, :]                  # [B,nC,i,j,H]
    causal = torch.tril(torch.ones((Lc, Lc), dtype=torch.bool, device=dev))
    decay_ij = torch.where(causal[None, None, :, :, None], torch.exp(seg), 0.0)
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)                       # [B,nC,i,j]
    y_intra = torch.einsum("bcij,bcijh,bcjhp->bcihp", cb, decay_ij, xc)

    # chunk summary states: S_c = Σ_j exp(la_last - la_j) B_j ⊗ xdt_j
    last = la[:, :, -1:, :]                                            # [B,nC,1,H]
    decay_tail = torch.exp(last - la)                                  # [B,nC,Lc,H]
    S_c = torch.einsum("bcjn,bcjh,bcjhp->bchpn", bc, decay_tail, xc)

    # inter-chunk recurrence over the nC states: h_c = exp(la_last_c) h_{c-1} + S_c
    a_chunk = torch.exp(last[:, :, 0, :])                              # [B,nC,H]
    h = (h_init.float() if h_init is not None
         else torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=dev))
    h_prevs = []
    for c in range(nC):
        h_prevs.append(h)
        h = a_chunk[:, c, :, None, None] * h + S_c[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                              # [B,nC,H,P,N]

    # inter-chunk output: y += exp(la_i) * C_i · h_{c-1}
    y_inter = torch.einsum("bcin,bcih,bchpn->bcihp", cc, torch.exp(la), h_prevs)
    y = (y_intra + y_inter).reshape(Bsz, S + pad, H, P)[:, :S]
    return y, h


def init_mamba_cache(cfg, batch: int, dtype, device):
    d_in, H, P, N = _dims(cfg)
    w = cfg.conv_width - 1
    return {
        "conv_x": torch.zeros((batch, w, d_in), dtype=dtype, device=device),
        "conv_B": torch.zeros((batch, w, N), dtype=dtype, device=device),
        "conv_C": torch.zeros((batch, w, N), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, H, P, N), dtype=torch.float32, device=device),
    }


def _write_cache(cache: dict, conv_x, conv_B, conv_C, ssm) -> dict:
    """The new states written into ``cache`` in place, cast to its dtypes."""
    for name, val in (("conv_x", conv_x), ("conv_B", conv_B), ("conv_C", conv_C),
                      ("ssm", ssm)):
        cache[name].copy_(val)
    return cache


def mamba_block(p: dict, x: torch.Tensor, cfg, *, cache: Optional[dict] = None):
    """Mamba2 mixer. Train/prefill: chunked SSD. Decode (S==1): O(1) update.

    Returns (y [B,S,d], cache or None): a decode step, or a prefill given a
    cache to seed, writes its conv and SSM states into ``cache`` in place.
    """
    Bsz, S, d = x.shape
    d_in, H, P, N = _dims(cfg)
    z = x @ p["in_proj_z"]
    xs = x @ p["in_proj_x"]
    Bc = x @ p["in_proj_B"]
    Cc = x @ p["in_proj_C"]
    dt = x @ p["in_proj_dt"]
    conv = p["conv"]

    new_cache = None
    if cache is not None and S == 1:
        xs, st_x = _causal_conv(xs, conv["wx"], conv["bx"], state=cache["conv_x"])
        Bc, st_B = _causal_conv(Bc, conv["wB"], conv["bB"], state=cache["conv_B"])
        Cc, st_C = _causal_conv(Cc, conv["wC"], conv["bC"], state=cache["conv_C"])
        dt_s = softplus(dt.float() + p["dt_bias"])                   # [B,1,H]
        a = torch.exp(-softplus(p["A_log"]) * dt_s)                  # [B,1,H]
        xh = xs.reshape(Bsz, 1, H, P).float() * dt_s[..., None]
        h = cache["ssm"]
        h = (a[:, 0, :, None, None] * h
             + xh[:, 0, :, :, None] * Bc.float()[:, 0, None, None, :])
        y = torch.einsum("bhpn,bn->bhp", h, Cc.float()[:, 0])
        y = y[:, None] + p["D"][None, None, :, None] * xs.reshape(Bsz, 1, H, P).float()
        new_cache = _write_cache(cache, st_x, st_B, st_C, h)
    else:
        xs, st_x = _causal_conv(xs, conv["wx"], conv["bx"])
        Bc, st_B = _causal_conv(Bc, conv["wB"], conv["bB"])
        Cc, st_C = _causal_conv(Cc, conv["wC"], conv["bC"])
        dt_s = softplus(dt.float() + p["dt_bias"])                   # [B,S,H]
        a = torch.exp(-softplus(p["A_log"]) * dt_s)
        xh = xs.reshape(Bsz, S, H, P).float() * dt_s[..., None]
        y, h_fin = ssd_chunked(xh, a, Bc, Cc, cfg.ssm_chunk)
        y = y + p["D"][None, None, :, None] * xs.reshape(Bsz, S, H, P).float()
        if cache is not None:  # prefill that seeds a decode cache
            new_cache = _write_cache(cache, st_x, st_B, st_C, h_fin)

    y = y.reshape(Bsz, S, d_in).to(x.dtype)
    # gated RMSNorm (mamba2's norm-before-out-proj, gated by z)
    y = rmsnorm(y * silu(z), p["norm_scale"], cfg.norm_eps)
    return y @ p["out_proj"], new_cache
