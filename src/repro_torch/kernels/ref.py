"""Plain PyTorch versions of the port's kernels (the ``ref.py`` contract).

Each is the semantic ground truth its kernel is held against on the card,
and the CPU path: a wrapper given a CPU tensor computes this.  ``ssd_ref``
and ``ssd_chunked_ref`` are also the JAX package's own plain versions of the
SSD scan; ``ssd_scan_ref`` is the function the SSD kernel computes.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import Tensor

INF = 3.0e38


def advance_sweep_ref(rem: Tensor, rate: Tensor, active: Tensor,
                      bound_dt: Tensor) -> tuple[Tensor, Tensor]:
    """dt to the next completion (capped by ``bound_dt``) + work depletion.

    Rank-polymorphic like ``repro.kernels.ref.advance_sweep_ref``: ``[C]``
    with a scalar bound gives a scalar ``dt``; ``[B, C]`` with a ``[B]``
    bound gives ``dt [B]``, the same per-row arithmetic.  ``rem - rate * dt``
    is two rounded operations (PyTorch never fuses them into an FMA), which
    the CUDA kernel reproduces bit for bit.
    """
    dt_fin = torch.where(active & (rate > 0), rem / rate.clamp_min(1e-30), INF)
    # min with initial=INF: pad the row so an empty row reduces to INF
    row_min = torch.nn.functional.pad(dt_fin, (0, 1), value=INF).amin(-1)
    dt = torch.minimum(row_min, bound_dt)
    new_rem = torch.where(
        active, (rem - rate * dt[..., None]).clamp_min(0.0), rem)
    return dt, new_rem


NEG = -1.0e30


def attention_mask(sq: int, sk: int, causal: bool, window: int | None,
                   device=None) -> Tensor:
    """``[sq, sk]`` bool.  Rows are aligned to the end of the key axis:
    query i sees keys ``<= i + (sk - sq)`` under causal masking, and keys
    ``> row - window`` under a sliding window."""
    row = torch.arange(sq, device=device)[:, None] + (sk - sq)
    col = torch.arange(sk, device=device)[None, :]
    mask = torch.ones(sq, sk, dtype=torch.bool, device=device)
    if causal:
        mask &= col <= row
    if window is not None:
        mask &= col > row - window
    return mask


def attention_ref(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                  window: int | None = None, softcap: float = 0.0,
                  scale: float | None = None) -> Tensor:
    """Softmax attention with GQA, sliding window and logit softcap, in f32,
    with the conventions of the flash kernel
    (``repro/kernels/flash_attention.py::_flash_kernel``):

    * q ``[B, Hq, Sq, D]``, k/v ``[B, Hk, Sk, D]``; query head h reads kv
      head ``h // (Hq // Hk)``.
    * ``scale`` multiplies the product ``q . k``; the softcap
      ``c * tanh(s / c)`` comes before the mask; masked logits are -1e30.
    * A row whose keys are all masked gives 0 (``p = 0`` where
      ``s <= -5e29``, ``l`` floored at 1e-30), like the Pallas kernel.  The
      JAX package's ``ref.attention_ref`` gives such a row the uniform
      average instead; serving never makes one (``Sq == Sk``).

    The result has q's dtype.
    """
    b, hq, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    g = hq // hk
    scale = d ** -0.5 if scale is None else scale
    qg = q.reshape(b, hk, g, sq, d).float()
    # in place where it saves a [.., Sq, Sk] buffer (the card holds long
    # ones), unless autograd needs the intermediates
    inplace = not (torch.is_grad_enabled() and
                   (q.requires_grad or k.requires_grad or v.requires_grad))

    def op(t: Tensor, name: str, *args) -> Tensor:
        return getattr(t, name + "_" if inplace else name)(*args)

    s = op(torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()), "mul", scale)
    if softcap > 0.0:
        s = op(op(op(s, "div", softcap), "tanh"), "mul", softcap)
    s = op(s, "masked_fill", ~attention_mask(sq, sk, causal, window, q.device),
           NEG)
    keep = s > NEG / 2
    p = op(op(op(s, "sub", s.amax(-1, keepdim=True)), "exp"), "masked_fill",
           ~keep, 0.0)
    l_sum = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float()) / l_sum
    return out.reshape(b, hq, sq, d).to(q.dtype)


def _capped_logits(q: Tensor, k: Tensor, softcap: float, scale: float):
    """``(s, t)``: the logits ``[B, Hk, G, Sq, Sk]`` f32 of query head
    ``hk * G + g``, capped (``c * tanh(s / c)``) where ``softcap > 0``, and
    ``t = tanh(s / c)`` (None without a softcap)."""
    b, hq, sq, d = q.shape
    hk = k.shape[1]
    qg = q.reshape(b, hk, hq // hk, sq, d).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale
    if softcap > 0.0:
        t = torch.tanh(s / softcap)
        return softcap * t, t
    return s, None


def attention_lse_ref(q: Tensor, k: Tensor, *, causal: bool = True,
                      window: int | None = None, softcap: float = 0.0,
                      scale: float | None = None) -> Tensor:
    """The row log-sum-exp of ``attention_ref``'s capped, masked logits,
    f32 ``[B, Hq, Sq]`` in natural-log units, as the flash kernel writes it
    on request; ``+inf`` for a row whose keys are all masked, so that
    ``exp(s - lse)`` is 0 there."""
    b, hq, sq, d = q.shape
    sk = k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    s, _ = _capped_logits(q, k, softcap, scale)
    mask = attention_mask(sq, sk, causal, window, q.device)
    lse = s.masked_fill(~mask, -torch.inf).logsumexp(-1)
    lse = lse.masked_fill(~mask.any(-1), torch.inf)
    return lse.reshape(b, hq, sq)


def attention_bwd_ref(q: Tensor, k: Tensor, v: Tensor, o: Tensor,
                      lse: Tensor, do: Tensor, *, causal: bool = True,
                      window: int | None = None, softcap: float = 0.0,
                      scale: float | None = None
                      ) -> tuple[Tensor, Tensor, Tensor]:
    """The gradient of ``attention_ref`` (dq, dk, dv in the inputs' dtypes)
    by the flash backward's arithmetic, in f32 (dP - delta in f64), from its
    output ``o`` and
    row log-sum-exp ``lse`` (``attention_lse_ref``)::

        P  = mask ? exp(s - lse) : 0;   dV = P^T dO;   dP = dO V^T
        dS = P (dP - rowsum(dO o)) (1 - (s / c)^2 under a softcap c)
        dQ = scale dS K;   dK = scale dS^T Q

    A row whose keys are all masked (``lse = +inf``) gets a zero dQ and
    adds nothing to dK or dV.  GQA: dK and dV sum over the query heads of
    their group."""
    b, hq, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    g = hq // hk
    scale = d ** -0.5 if scale is None else scale
    s, t = _capped_logits(q, k, softcap, scale)
    mask = attention_mask(sq, sk, causal, window, q.device)
    lse_g = lse.reshape(b, hk, g, sq, 1).float()
    p = torch.exp(s.sub_(lse_g)).masked_fill_(~mask, 0.0)
    del s
    dog = do.reshape(b, hk, g, sq, d)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, dog.float())
    # dP - delta cancels where a row's softmax is nearly one-hot (a row that
    # sees one key has dS = 0 exactly): both are taken in f64, so that the
    # plain version's dq there is 0 to f32 precision, as jax.grad's is
    dog = dog.double()
    delta = (dog * o.reshape(b, hk, g, sq, d).double()).sum(-1, keepdim=True)
    ds = (torch.einsum("bhgqd,bhkd->bhgqk", dog, v.double()).sub_(delta)
          .float().mul_(p))
    del p
    if t is not None:
        ds.mul_(1.0 - t * t)
    qg = q.reshape(b, hk, g, sq, d).float()
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, k.float()) * scale
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qg) * scale
    return (dq.reshape(b, hq, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


# ---------------------------------------------------------------------------
# Mamba2 SSD (state-space duality)
# ---------------------------------------------------------------------------

def _heads(m: Tensor, h: int) -> Tensor:
    """``[B, S, G, N]`` -> ``[B, S, H, N]`` f32: head h reads group
    ``h // (H // G)``."""
    return m.float().repeat_interleave(h // m.shape[2], dim=2)


def ssd_ref(x: Tensor, dt: Tensor, A: Tensor, Bm: Tensor, Cm: Tensor,
            D: Tensor) -> Tensor:
    """Sequential scan: ``y_t = C_t h_t + D x_t`` with
    ``h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T``, in f32.

    x ``[B, S, H, P]``, dt ``[B, S, H]`` (post-softplus), A ``[H]`` (< 0),
    Bm/Cm ``[B, S, G, N]``, D ``[H]``; y in x's dtype.
    """
    b, s, h, p = x.shape
    Bh, Ch = _heads(Bm, h), _heads(Cm, h)
    xf, dtf = x.float(), dt.float()
    state = x.new_zeros((b, h, p, Bm.shape[3]), dtype=torch.float32)
    ys = []
    for t in range(s):
        decay = torch.exp(dtf[:, t] * A)[..., None, None]          # [B,H,1,1]
        upd = (dtf[:, t, :, None, None] * xf[:, t, :, :, None]) \
            * Bh[:, t, :, None, :]
        state = decay * state + upd                                 # [B,H,P,N]
        ys.append(torch.einsum("bhpn,bhn->bhp", state, Ch[:, t]))
    y = torch.stack(ys, 1) + D[None, None, :, None] * xf
    return y.to(x.dtype)


def ssd_chunked_ref(x: Tensor, dt: Tensor, A: Tensor, Bm: Tensor, Cm: Tensor,
                    D: Tensor, chunk: int = 64, return_state: bool = False):
    """Chunk-parallel SSD, the math of the kernel (and of the JAX package's
    ``ref.ssd_chunked_ref``, its training path).  S must be a multiple of
    ``chunk``.  With ``return_state`` also returns the final ``[B, H, P, N]``
    state.

    The intra-chunk decay ``exp(cum_i - cum_j)`` is masked to ``i >= j``
    *before* the exponential.  The reference exponentiates the whole
    ``[Q, Q]`` square and then selects; the masked entries (``i < j``) have
    ``cum_i - cum_j > 0`` and overflow to inf once ``sum dt |A|`` over a
    chunk passes ~88, and the gradient of the select is then ``0 * inf =
    NaN``.  Masking first gives the same values and a finite gradient.
    """
    b, s, h, p = x.shape
    n = Bm.shape[3]
    if s % chunk:
        raise ValueError(f"ssd_chunked_ref: S={s} is not a multiple of "
                         f"chunk={chunk} (pad with dt = 0)")
    nc = s // chunk
    xc = x.float().reshape(b, nc, chunk, h, p)
    dtc = dt.float().reshape(b, nc, chunk, h)
    Bc = _heads(Bm, h).reshape(b, nc, chunk, h, n)
    Cc = _heads(Cm, h).reshape(b, nc, chunk, h, n)

    cum = torch.cumsum(dtc * A, dim=2)                        # [B,nc,Q,H]
    seg = cum[:, :, -1, :]                                    # [B,nc,H]

    # intra-chunk (dual quadratic form)
    CB = torch.einsum("bcqhn,bckhn->bchqk", Cc, Bc)           # [B,nc,H,Q,K]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]      # [B,nc,Q,K,H]
    tri = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    L = diff.masked_fill(~tri[None, None, :, :, None], -torch.inf).exp()
    W = CB * L.movedim(-1, 2)                                 # [B,nc,H,Q,K]
    y_intra = torch.einsum("bchqk,bckh,bckhp->bcqhp", W, dtc, xc)

    # inter-chunk: carry the state across chunks
    w = torch.exp(seg[:, :, None, :] - cum) * dtc             # [B,nc,Q,H]
    state_in = torch.einsum("bcqhp,bcqh,bcqhn->bchpn", xc, w, Bc)
    decay = torch.exp(seg)                                    # [B,nc,H]
    state = x.new_zeros((b, h, p, n), dtype=torch.float32)
    before = []
    for c in range(nc):
        before.append(state)                                  # state BEFORE c
        state = decay[:, c, :, None, None] * state + state_in[:, c]
    h_prev = torch.stack(before, 1)                           # [B,nc,H,P,N]
    y_inter = torch.einsum("bcqhn,bchpn,bcqh->bcqhp", Cc, h_prev, cum.exp())
    y = (y_intra + y_inter).reshape(b, s, h, p)
    y = (y + D[None, None, :, None] * x.float()).to(x.dtype)
    if return_state:
        return y, state
    return y


def ssd_scan_ref(x: Tensor, dt: Tensor, A: Tensor, Bm: Tensor, Cm: Tensor,
                 D: Tensor, *, chunk: int = 128, return_state: bool = False):
    """What the SSD kernel computes (and the JAX package's
    ``ssd_scan_pallas``): the chunked scan over S padded up to a multiple of
    ``chunk`` with ``dt = 0`` (identity steps), cut back to S.  With
    ``return_state`` also the final ``[B, H, P, N]`` state, which the
    padded steps leave as the state at S."""
    s = x.shape[1]
    pad = (-s) % chunk
    if pad:
        x, Bm, Cm = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, Bm, Cm))
        dt = F.pad(dt, (0, 0, 0, pad))
    out = ssd_chunked_ref(x, dt, A, Bm, Cm, D, chunk=chunk,
                          return_state=return_state)
    if return_state:
        return out[0][:, :s], out[1]
    return out[:, :s]


def ssd_scan_bwd_ref(x: Tensor, dt: Tensor, A: Tensor, Bm: Tensor,
                     Cm: Tensor, D: Tensor, dy: Tensor, *, chunk: int = 128
                     ) -> tuple[Tensor, ...]:
    """The gradient of ``ssd_scan_ref`` for the output's gradient ``dy``,
    by the SSD backward kernel's chunked formulas written out in f32:
    ``(dx, ddt, dA, dBm, dCm, dD)``, dx, dBm and dCm in their inputs'
    dtypes, ddt, dA and dD in f32.  S is padded to a multiple of ``chunk``
    with ``dt = 0`` and zero rows, as the forward pads it, and the
    gradients are cut back to S.

    Per (b, h) and chunk, with ``cum`` the within-chunk cumsum of
    ``dt A``, ``seg = cum[Q-1]``, ``L_ij = exp(cum_i - cum_j)`` for
    i >= j (masked before the exponential, as ``ssd_chunked_ref`` masks),
    ``S_ij = C_i . B_j``, ``R_ij = dy_i . x_j``, ``M = S L dt_j``,
    ``dS = R L dt_j``, ``w_j = exp(seg - cum_j) dt_j``, ``h`` the state
    entering the chunk and ``G`` the gradient of the state leaving it
    (``G = sum_i exp(cum_i) dy_i^T C_i + exp(seg) G_next`` over the chunks
    in reverse, zero after the last)::

        dx  = D dy + M^T dy + w (B G^T)
        dC  = dS B + exp(cum) (dy h)
        dB  = dS^T C + w (x G)
        dcum_i = sum_j M_ij R_ij - sum_j M_ji R_ji
                 + exp(cum_i) dy_i . (C_i h^T) - dw_i w_i
                 (+ exp(seg) <G, h> + sum_j dw_j w_j at i = Q-1)
        ddt = sum_i S_ij L_ij R_ij + dw_j exp(seg - cum_j) + A da_j

    with ``dw_j = x_j . (G B_j)`` and ``da`` the reverse cumsum of
    ``dcum`` within the chunk; ``dA = sum dt da``, ``dD = sum dy x``.
    dBm and dCm sum the heads of their group.
    """
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    pad = (-s) % chunk
    if pad:
        x, Bm, Cm, dy = (F.pad(t, (0, 0, 0, 0, 0, pad))
                         for t in (x, Bm, Cm, dy))
        dt = F.pad(dt, (0, 0, 0, pad))
    nc = (s + pad) // chunk
    shape = (b, nc, chunk, h)
    xc = x.float().reshape(*shape, p)
    dyc = dy.float().reshape(*shape, p)
    dtc = dt.float().reshape(shape)
    Bc = _heads(Bm, h).reshape(*shape, n)
    Cc = _heads(Cm, h).reshape(*shape, n)
    Af = A.float()

    cum = torch.cumsum(dtc * Af, dim=2)                       # [B,nc,Q,H]
    seg = cum[:, :, -1, :]                                    # [B,nc,H]
    tri = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]      # [B,nc,Q,K,H]
    L = diff.masked_fill(~tri[None, None, :, :, None], -torch.inf).exp()
    L = L.movedim(-1, 2)                                      # [B,nc,H,Q,K]
    Ldt = L * dtc.movedim(-1, 2)[:, :, :, None, :]
    S = torch.einsum("bcqhn,bckhn->bchqk", Cc, Bc)
    R = torch.einsum("bcqhp,bckhp->bchqk", dyc, xc)
    M, dS = S * Ldt, R * Ldt

    # the states entering each chunk, and the gradients leaving each chunk
    w = torch.exp(seg[:, :, None, :] - cum) * dtc             # [B,nc,Q,H]
    ecum = cum.exp()
    s_c = torch.einsum("bcqhp,bcqh,bcqhn->bchpn", xc, w, Bc)
    u_c = torch.einsum("bcqhp,bcqh,bcqhn->bchpn", dyc, ecum, Cc)
    decay = torch.exp(seg)[..., None, None]                   # [B,nc,H,1,1]
    state = x.new_zeros((b, h, p, n), dtype=torch.float32)
    grad = torch.zeros_like(state)
    h_in, g_out = [], [None] * nc
    for c in range(nc):
        h_in.append(state)
        state = decay[:, c] * state + s_c[:, c]
    for c in reversed(range(nc)):
        g_out[c] = grad
        grad = u_c[:, c] + decay[:, c] * grad
    hc, Gc = torch.stack(h_in, 1), torch.stack(g_out, 1)      # [B,nc,H,P,N]

    GB = torch.einsum("bchpn,bckhn->bckhp", Gc, Bc)           # G B_j
    xG = torch.einsum("bckhp,bchpn->bckhn", xc, Gc)           # x_j G
    dyh = torch.einsum("bcqhp,bchpn->bcqhn", dyc, hc)         # dy_i h
    dx = (D.float()[:, None] * dyc
          + torch.einsum("bchqk,bcqhp->bckhp", M, dyc) + w[..., None] * GB)
    dC = torch.einsum("bchqk,bckhn->bcqhn", dS, Bc) + ecum[..., None] * dyh
    dB = torch.einsum("bchqk,bcqhn->bckhn", dS, Cc) + w[..., None] * xG

    Z = M * R                                                 # [B,nc,H,Q,K]
    dw = (xc * GB).sum(-1)                                    # [B,nc,Q,H]
    dcum = ((Z.sum(-1) - Z.sum(-2)).movedim(2, -1)
            + ecum * (Cc * dyh).sum(-1) - dw * w)
    dseg = decay[..., 0, 0] * (Gc * hc).sum((-2, -1)) + (dw * w).sum(2)
    dcum[:, :, -1] += dseg
    da = dcum.flip(2).cumsum(2).flip(2)
    ddt = ((S * L * R).sum(-2).movedim(2, -1)
           + dw * torch.exp(seg[:, :, None, :] - cum) + Af * da)
    dA = (dtc * da).sum((0, 1, 2))
    dD = (dyc * xc).sum((0, 1, 2, 4))

    def cut(t: Tensor, width: int) -> Tensor:
        return t.reshape(b, nc * chunk, -1, width)[:, :s]

    dBm = cut(dB, n).reshape(b, s, g, h // g, n).sum(3)
    dCm = cut(dC, n).reshape(b, s, g, h // g, n).sum(3)
    return (cut(dx, p).to(x.dtype), ddt.reshape(b, nc * chunk, h)[:, :s],
            dA, dBm.to(Bm.dtype), dCm.to(Cm.dtype), dD)
