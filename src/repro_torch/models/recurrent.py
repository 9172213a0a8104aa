"""Recurrent mixers (port of ``repro/models/recurrent.py``): the RG-LRU block
(RecurrentGemma/Griffin) and RWKV6 (Finch) time and channel mix.

Both are linear recurrences, plain jnp in the reference (no Pallas kernel),
so plain torch here. The full-sequence forms are parallel: RG-LRU's
``h_t = a_t h_{t-1} + b_t`` runs as a log-depth doubling scan in fp32
(``scan_linear``: ⌈log2 S⌉ rounds of whole-tensor ops, where the reference
calls ``jax.lax.associative_scan``; the two sum in different trees, so they
agree within fp32 rounding, not bit for bit), RWKV6's matrix state as the
reference's exact chunked form (``wkv_chunked``, fp32). Decode carries a
fixed-size state and writes it **in place** into the cache views it is
given, as ``GQAttention.decode`` writes K/V, so a CUDA graph of the step
advances it on every replay.

Every bf16 elementwise op rounds where the reference's does: sigmoid is
``jax.nn.sigmoid``'s ``1 / (1 + exp(-x))`` op by op, softplus is
``logaddexp(x, 0)`` (not ``F.softplus``'s threshold), GELU and SiLU are
``models/mlp.py``'s. The projections call ``apply_linear`` with no name and
no ``aq``, as the reference does: calibration records them under their
block's scope, no leaf gets an ``_aq`` sibling, and after ``quantize`` they
quantize dynamically.

One deliberate difference from the reference: the RG-LRU prefill keeps the
causal conv's *inputs* (the ``w_x`` projection of the last ``conv1d_width -
1`` tokens) as the decode window, which is what ``decode`` contracts with
the conv kernel. The reference stores the conv's outputs there
(``recurrent.py:62`` reassigns ``u``), so its first decode steps after a
prefill disagree with a forward over the same tokens (ROADMAP queue 3).
"""
from __future__ import annotations

import dataclasses
import functools

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.models.common import Param, apply_linear, linear_def, shard
from repro_torch.models.mlp import gelu, sigmoid, silu

_C_RGLRU = 8.0  # Griffin's fixed recurrence sharpness


def softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` as jnp computes it."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def scan_linear(a, b):
    """``h_t = a_t h_{t-1} + b_t`` along axis 1 from ``h_{-1} = 0``: the
    reference's ``associative_scan`` with ``comb(l, r) = (l.a r.a, r.a l.b +
    r.b)``, as a doubling scan (Hillis–Steele). Returns every ``h_t``."""
    s, d = a.shape[1], 1
    while d < s:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def causal_conv1d(u, kernel):
    """Depthwise causal conv: u (B, S, D), kernel (W, D); the sum in fp32,
    tap by tap, rounded once to u's dtype."""
    w = kernel.shape[0]
    pad = torch.nn.functional.pad(u, (0, 0, w - 1, 0))
    out = torch.zeros(u.shape, dtype=torch.float32, device=u.device)
    for i in range(w):
        out = out + pad[:, i: i + u.shape[1]].float() * kernel[i].float()
    return out.to(u.dtype)


# ---------------------------------------------------------------------------
# RG-LRU block (Griffin recurrent block: proj -> conv1d -> RG-LRU, gated)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RGLRUBlock:
    cfg: "ModelConfig"  # noqa: F821

    def defs(self):
        c = self.cfg
        dr = c.d_rnn_
        dbb = c.dbb
        return {
            "w_x": linear_def(c.d_model, dr, "embed", "mlp", dbb=dbb),
            "w_gate": linear_def(c.d_model, dr, "embed", "mlp", dbb=dbb),
            "conv_k": Param((c.conv1d_width, dr), (None, "mlp"), "scaled"),
            "w_a": linear_def(dr, dr, "mlp", None, dbb=dbb),  # recurrence gate
            "w_i": linear_def(dr, dr, "mlp", None, dbb=dbb),  # input gate
            "log_lambda": Param((dr,), (None,), "ones", scale=0.5),
            "w_out": linear_def(dr, c.d_model, "mlp", "embed", dbb=dbb),
        }

    def _gates(self, p, u):
        """(a, b): the recurrence's fp32 decay and gated input."""
        a_exp = sigmoid(apply_linear(u, p["w_a"]))
        log_a = -_C_RGLRU * a_exp.float() * softplus(p["log_lambda"].float())
        a = torch.exp(log_a)
        gated_in = sigmoid(apply_linear(u, p["w_i"])) * u
        beta = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12))
        return a, beta * gated_in.float()

    def __call__(self, p, x, positions=None):
        """Full sequence. x: (B, S, d) -> (y, {"h": (B, d_rnn) fp32, "conv":
        the conv's last W - 1 inputs}). On a mesh the conv and the scan run
        under ``local_map`` on each rank's batch rows and features (both
        act feature by feature along the whole sequence): no DTensor-level
        op inside them, whose strategy search costs seconds on a 3-D
        mesh."""
        c = self.cfg
        u_in = shard(apply_linear(x, p["w_x"]), ("batch", None, "mlp"))
        local = getattr(u_in, "placements", None)
        u = _local(causal_conv1d, u_in, p["conv_k"], in_pl=(
            local, getattr(p["conv_k"], "placements", None)), out_pl=(local,))
        a, bx = self._gates(p, u)
        a, bx = shard(a, ("batch", None, "mlp")), shard(bx, ("batch", None, "mlp"))
        h = _local(scan_linear, a, bx, in_pl=(local, local), out_pl=(local,)).to(x.dtype)
        gate = gelu(apply_linear(x, p["w_gate"]))
        y = apply_linear(h * gate, p["w_out"])
        conv = _local(functools.partial(_window, n=c.conv1d_width - 1), u_in, in_pl=(local,),
                      out_pl=(local,))
        return y, {"h": h[:, -1].float(), "conv": conv}

    def init_cache(self, batch, max_len, dtype, device=None):
        c = self.cfg
        dr = c.d_rnn_
        return {"h": torch.zeros((batch, dr), dtype=torch.float32, device=device),
                "conv": torch.zeros((batch, c.conv1d_width - 1, dr), dtype=dtype, device=device)}

    def decode(self, p, x, cache, pos=None):
        """One token, x: (B, 1, d). The conv window in x's dtype, contracted
        with the kernel (fp32 sums, one rounding, as XLA's bf16 dot). Writes
        ``h`` and the shifted window into ``cache`` in place."""
        u = apply_linear(x, p["w_x"])
        hist = torch.cat([cache["conv"].to(u.dtype), u], dim=1)
        kern = p["conv_k"].to(u.dtype)
        acc = torch.zeros((hist.shape[0], hist.shape[2]), dtype=torch.float32, device=x.device)
        for i in range(hist.shape[1]):
            acc = acc + hist[:, i].float() * kern[i].float()
        a, bx = self._gates(p, acc.to(u.dtype)[:, None])
        h = a[:, 0] * cache["h"] + bx[:, 0]
        gate = gelu(apply_linear(x, p["w_gate"]))
        y = apply_linear(h[:, None].to(x.dtype) * gate, p["w_out"])
        cache["h"].copy_(h)
        cache["conv"].copy_(hist[:, 1:])
        return y, cache


def _window(u, n):
    """The last ``n`` steps of u (B, S, D), zero-padded in front when S < n,
    as a decode from an empty cache would hold them."""
    if n == 0:
        return u[:, :0]
    return torch.nn.functional.pad(u, (0, 0, max(n - u.shape[1], 0), 0))[:, -n:]


# ---------------------------------------------------------------------------
# RWKV6 time-mix + channel-mix
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RWKV6Block:
    cfg: "ModelConfig"  # noqa: F821

    def defs(self):
        c = self.cfg
        dm = c.d_model
        h, hd = c.rwkv_heads, c.rwkv_head_dim
        dbb = c.dbb
        lora = 64
        tm = {
            "mu": Param((5, dm), (None, "embed"), "zeros"),  # w,k,v,r,g ddlerp base
            "mu_x": Param((dm,), ("embed",), "zeros"),
            "w_r": linear_def(dm, h * hd, "embed", "heads", dbb=dbb),
            "w_k": linear_def(dm, h * hd, "embed", "heads", dbb=dbb),
            "w_v": linear_def(dm, h * hd, "embed", "heads", dbb=dbb),
            "w_g": linear_def(dm, h * hd, "embed", "heads", dbb=dbb),
            "w_o": linear_def(h * hd, dm, "heads", "embed", dbb=dbb),
            "decay_base": Param((h * hd,), ("heads",), "normal", scale=1.0),
            "w_decay_a": linear_def(dm, lora, "embed", None),
            "w_decay_b": linear_def(lora, h * hd, None, "heads"),
            "u": Param((h, hd), (None, None), "normal", scale=0.5),
            "ln_g": Param((h * hd,), ("heads",), "ones"),
            "ln_b": Param((h * hd,), ("heads",), "zeros"),
        }
        cm = {
            "mu_k": Param((dm,), ("embed",), "zeros"),
            "mu_r": Param((dm,), ("embed",), "zeros"),
            "w_k": linear_def(dm, c.d_ff, "embed", "mlp", dbb=dbb),
            "w_v": linear_def(c.d_ff, dm, "mlp", "embed", dbb=dbb),
            "w_r": linear_def(dm, dm, "embed", None, dbb=dbb),
        }
        return {"tm": tm, "cm": cm}

    # ---------------------------------------------------------- time mix
    def _tm_inputs(self, p, x, x_prev):
        """ddlerp-lite: the shifted mixes for the w, k, v, r, g channels."""
        xx = x_prev - x
        return [x + xx * p["mu"][i].to(x.dtype) for i in range(5)]

    def _decay(self, p, xw):
        """The fp32 log-decay (<= 0); ``w_decay_a``/``w_decay_b`` are dense."""
        dd = apply_linear(torch.tanh(apply_linear(xw, p["w_decay_a"])), p["w_decay_b"])
        return -torch.exp(torch.clamp(p["decay_base"].float() + dd.float(), -8.0, 8.0))

    def _out(self, p, y, g, x):
        """The per-head group norm of the WKV output ``y`` (B, S, H·hd) fp32,
        gated by ``g`` and projected by ``w_o``. On a mesh ``y`` is whole
        along its features (the WKV ran data-parallel); the norm runs on
        each rank's rows under ``local_map``, then takes ``g``'s feature
        split (a local slice) for the row-parallel ``w_o``."""
        c = self.cfg
        rows = getattr(y, "placements", None)
        y = _local(functools.partial(group_norm, groups=c.rwkv_heads), y, p["ln_g"], p["ln_b"],
                   in_pl=(rows, None, None), out_pl=(rows,))
        y = shard(y, ("batch", None, "heads"))
        return apply_linear(y.to(x.dtype) * g, p["w_o"])

    def _heads(self, *ts):
        """The projections (B, S, H·hd) on a mesh taken whole along their
        features (replicated over 'model', the reference's "WKV
        data-parallel": the heads need not divide the mesh), split only by
        the batch; as they are on one device."""
        return [shard(t, ("batch", None, None)) for t in ts]

    def time_mix(self, p, x, x_prev_tok):
        """x: (B, S, d); x_prev_tok: (B, d), the token before the segment.
        Returns (y, {"s": (B, H, hd, hd) fp32, "shift": x's last token}).
        On a mesh the sequence is gathered first (the token shift reads the
        token before each one) and the WKV runs on each rank's batch rows
        under ``local_map``."""
        c = self.cfg
        b, s, _ = x.shape
        h, hd = c.rwkv_heads, c.rwkv_head_dim
        x = shard(x, ("batch", None, "embed"))
        xs = torch.cat([x_prev_tok[:, None], x[:, :-1]], dim=1)
        xw, xk, xv, xr, xg = self._tm_inputs(p, x, xs)
        r, k, v = (apply_linear(xr, p["w_r"]), apply_linear(xk, p["w_k"]),
                   apply_linear(xv, p["w_v"]))
        g = silu(apply_linear(xg, p["w_g"]))
        r, k, v, wlog = self._heads(r, k, v, self._decay(p, xw))  # calibration order: r k v g w

        def wkv(r, k, v, wlog, u):  # (rows, S, H·hd) -> heads
            rows = r.shape[0]
            r, k, v, wlog = (t.reshape(rows, s, h, hd) for t in (r, k, v, wlog))
            return wkv_chunked(r, k, v, wlog, u.float(), chunk=c.wkv_chunk)

        rows = getattr(r, "placements", None)
        y, state = _local(wkv, r, k, v, wlog, p["u"], in_pl=(rows,) * 4 + (None,),
                          out_pl=(rows, rows))
        return self._out(p, y.reshape(b, s, h * hd), g, x), {"s": state, "shift": x[:, -1]}

    def time_mix_decode(self, p, x, cache):
        """One token; writes ``s`` and ``shift`` into ``cache`` in place. On
        a mesh the state update runs on each rank's batch rows under
        ``local_map``, the state keeping its cache layout."""
        c = self.cfg
        b = x.shape[0]
        h, hd = c.rwkv_heads, c.rwkv_head_dim
        xs = cache["shift"][:, None].to(x.dtype)
        xw, xk, xv, xr, xg = self._tm_inputs(p, x, xs)
        r, k, v = (apply_linear(xr, p["w_r"]), apply_linear(xk, p["w_k"]),
                   apply_linear(xv, p["w_v"]))
        g = silu(apply_linear(xg, p["w_g"]))
        r, k, v, wlog = self._heads(r, k, v, self._decay(p, xw))  # calibration order: r k v g w

        def step(r, k, v, wlog, u, s0):
            rows = r.shape[0]
            r, k, v = (t.reshape(rows, h, hd).float() for t in (r, k, v))
            w = torch.exp(wlog.reshape(rows, h, hd))
            u = u.float()
            kv = k[..., :, None] * v[..., None, :]  # (B, H, hd, hd)
            y = torch.einsum("bhk,bhkv->bhv", r, s0 + u[None, :, :, None] * kv)
            return y, w[..., :, None] * s0 + kv

        rows = getattr(r, "placements", None)
        y, s1 = _local(step, r, k, v, wlog, p["u"], cache["s"],
                       in_pl=(rows,) * 4 + (None, getattr(cache["s"], "placements", None)),
                       out_pl=(rows, rows))
        y = self._out(p, y.reshape(b, 1, h * hd), g, x)
        cache["s"].copy_(s1)
        cache["shift"].copy_(x[:, -1])
        return y, cache

    # ------------------------------------------------------- channel mix
    def channel_mix(self, p, x, x_prev_tok):
        x = shard(x, ("batch", None, "embed"))  # the token shift reads along the sequence
        xs = torch.cat([x_prev_tok[:, None], x[:, :-1]], dim=1)
        return self._cm(p, x, xs), x[:, -1]

    def channel_mix_decode(self, p, x, cache):
        """One token; writes ``cm_shift`` into ``cache`` in place."""
        y = self._cm(p, x, cache["cm_shift"][:, None].to(x.dtype))
        cache["cm_shift"].copy_(x[:, -1])
        return y

    def _cm(self, p, x, xs):
        xx = xs - x
        xk = x + xx * p["mu_k"].to(x.dtype)
        xr = x + xx * p["mu_r"].to(x.dtype)
        k = torch.relu(apply_linear(xk, p["w_k"]))
        k = shard(k * k, ("batch", None, "mlp"))
        return sigmoid(apply_linear(xr, p["w_r"])) * apply_linear(k, p["w_v"])

    # ------------------------------------------------------------ caches
    def init_cache(self, batch, max_len, dtype, device=None):
        c = self.cfg
        h, hd = c.rwkv_heads, c.rwkv_head_dim
        return {"s": torch.zeros((batch, h, hd, hd), dtype=torch.float32, device=device),
                "shift": torch.zeros((batch, c.d_model), dtype=dtype, device=device),
                "cm_shift": torch.zeros((batch, c.d_model), dtype=dtype, device=device)}


def _local(fn, *args, in_pl, out_pl):
    """``fn(*args)`` on each rank's local tensors under ``local_map`` where
    the first argument is a DTensor; on plain tensors ``fn`` itself.
    ``in_pl`` gives each argument's placements (None: replicated whole, a
    small parameter), ``out_pl`` each output's. A gradient takes its
    argument's placements, except that a replicated argument's is a
    partial sum over the mesh dims that split the first output (each rank
    differentiates its own rows or features)."""
    if not isinstance(args[0], DTensor):
        return fn(*args)
    from torch.distributed.tensor.experimental import local_map

    mesh = args[0].device_mesh
    whole = (Replicate(),) * mesh.ndim
    split = [j for j, pl in enumerate(out_pl[0]) if isinstance(pl, Shard)]
    in_pl = tuple(whole if pl is None else tuple(pl) for pl in in_pl)
    grad = tuple(tuple(Partial() if j in split and isinstance(q, Replicate) else q
                       for j, q in enumerate(pl)) for pl in in_pl)
    return local_map(fn, out_placements=tuple(map(tuple, out_pl)), in_placements=in_pl,
                     in_grad_placements=grad, device_mesh=mesh, redistribute_inputs=True)(*args)


def group_norm(y, gamma, beta, groups):
    """Per-head layer norm of y (B, S, d) in fp32, then fp32 gamma and beta."""
    b, s, d = y.shape
    yg = y.reshape(b, s, groups, d // groups).float()
    mu = yg.mean(-1, keepdim=True)
    var = yg.var(-1, keepdim=True, unbiased=False)
    yn = ((yg - mu) * torch.rsqrt(var + 1e-5)).reshape(b, s, d)
    return yn * gamma.float() + beta.float()


def wkv_chunked(r, k, v, wlog, u, *, chunk=64):
    """Exact chunked RWKV6 WKV with per-dimension data-dependent decay.

    r, k, v: (B, S, H, D); wlog: (B, S, H, D) log-decay (<= 0); u: (H, D)
    bonus. Returns y (B, S, H, D) fp32 and the final state (B, H, D, D)
    fp32. Recurrence: ``S_t = diag(w_t) S_{t-1} + k_t v_t^T``, ``y_t = r_t^T
    S_{t-1} + (r_t · (u * k_t)) v_t``. Every exponent is a non-positive
    difference of cumulative log decays, so exp() never overflows. A tail
    of S % chunk steps is zero-padded (decay 1, k = 0: the state is left
    as it is), as the reference pads it."""
    b, s, h, d = r.shape
    t = min(chunk, s)
    s_orig = s
    if s % t:
        pad = t - s % t
        r, k, v, wlog = (torch.nn.functional.pad(z, (0, 0, 0, 0, 0, pad)) for z in (r, k, v, wlog))
        s += pad
    n = s // t

    def resh(z):  # (B, S, H, D) -> (n, B, H, T, D)
        return z.float().reshape(b, n, t, h, d).permute(1, 0, 3, 2, 4)

    rr, kk, vv, ww = map(resh, (r, k, v, wlog))
    idx = torch.arange(t, device=r.device)
    tri = (idx[:, None] > idx[None, :])[None, None, :, :, None]
    state = torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device)
    ys = []
    for rc, kc, vc, wc in zip(rr, kk, vv, ww):  # (B, H, T, D) each
        cum = torch.cumsum(wc, dim=2)  # inclusive cumulative log decay
        cum_x = cum - wc  # exclusive
        y_inter = torch.einsum("bhtk,bhkv->bhtv", rc * torch.exp(cum_x), state)
        expo = cum_x[:, :, :, None] - cum[:, :, None]  # (B, H, T, T, D)
        dec = torch.where(tri, torch.exp(torch.clamp_max(expo, 0.0)), 0.0)
        a = (rc[:, :, :, None] * kc[:, :, None] * dec).sum(-1)
        y_intra = torch.einsum("bhti,bhiv->bhtv", a, vc)
        y_bonus = (rc * (u[None, :, None] * kc)).sum(-1, keepdim=True) * vc
        last = cum[:, :, -1:]
        k_t = kc * torch.exp(last - cum)
        state = torch.exp(last[:, :, 0])[..., None] * state + torch.einsum(
            "bhtk,bhtv->bhkv", k_t, vc)
        ys.append(y_inter + y_intra + y_bonus)
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(b, s, h, d)
    return y[:, :s_orig], state
