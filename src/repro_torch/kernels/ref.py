"""Plain PyTorch versions of the hand-written kernels.

The CPU tests run these, and ``chip_smoke.py`` holds each CUDA kernel
against its plain version on the card. They compute exactly what the
kernels compute, with the rows in the same order: in float32, except
that the Gram solve keeps its state in K's dtype as the reference does.

As the kernels, the solves take C, tol and max_epochs as numbers or as
(jobs,) tensors, one value a job, and their rows as home blocks
(n_home, per, ·) and shared rows (S, ·) or a stack of shared blocks
(B, S, ·): job l reads home block l % n_home and shared block
l // (jobs / B).
"""
from __future__ import annotations

import math

import torch

from repro_torch import sparse as sparse_rows


def _blocks(xh, xs, jobs: int, device):
    """Each job's home block and shared block: (jobs,) int64 each."""
    j = torch.arange(jobs, device=device)
    B = xs.shape[0] if len(xs.shape) == 3 else 1
    return j % xh.shape[0], j // (jobs // B)


def _shared3(xs):
    """Shared rows as a stack of blocks (B, S, ·)."""
    return xs if len(xs.shape) == 3 else xs[None]


def _rows(xh, xs, i: int, home, shared):
    """Row ``i`` of every job's augmented partition (L rows, dense or
    ``SparseRows``): row i of the job's home block for ``i < per``, else
    row i − per of its shared block (``home``, ``shared`` from
    :func:`_blocks`)."""
    return xh[home, i] if i < xh.shape[1] else \
        _shared3(xs)[shared, i - xh.shape[1]]


def _per_job(v, jobs: int, device, dtype=torch.float32):
    """A number or a (jobs,) tensor as a (jobs,) tensor."""
    return torch.as_tensor(v, dtype=dtype, device=device).expand(jobs)


def _dots(w: torch.Tensor, x: torch.Tensor):
    """(w·x, x·x) per job, each one float32 sum over all columns."""
    return (w * x).sum(-1), (x * x).sum(-1)


def _cd_step(wx, q, y, m, alpha, i: int, b, C, active):
    """Row ``i``'s dual-CD update of every job, in place on α and b, from
    its w·x and Q_ii (L,); C a number or (L,). Jobs whose ``active`` is 0
    take a step of exactly 0, so a stopped job keeps its state even where
    it is NaN, as the reference's ``vmap`` of a ``while_loop`` selects it.
    → (Δ·y (L,), |pg|·m (L,))."""
    yi, mi, ai = y[:, i], m[:, i], alpha[:, i]
    C = torch.as_tensor(C, dtype=torch.float32, device=ai.device)
    g = yi * (wx + b) - 1.0                           # ∂/∂α_i of dual obj
    pg = torch.where(ai <= 0.0, g.clamp(max=0.0),
                     torch.where(ai >= C, g.clamp(min=0.0), g))
    a_new = torch.minimum((ai - g / q).clamp(min=0.0), C)
    delta = torch.where(active > 0, (a_new - ai) * mi, 0.0)
    alpha[:, i] = ai + delta
    coef = delta * yi
    b += coef
    return coef, pg.abs() * mi


def _cd_epoch(xh, xs, y, m, alpha, w, b, C, active, dots=_dots):
    """One sequential dual-CD epoch over every job, in place.

    Jobs whose ``active`` is 0 keep their state; ``dots(w, x)`` gives
    each row's (w·x, x·x). → max projected-gradient violation of the
    epoch per job (L,).
    """
    L, n = y.shape
    home, shared = _blocks(xh, xs, L, y.device)
    viol = torch.zeros_like(b)
    for i in range(n):
        x = _rows(xh, xs, i, home, shared).float()
        wx, xx = dots(w, x)
        q = torch.where(m[:, i] > 0, xx + 1.0, 1.0)   # Q_ii, bias augment
        coef, v = _cd_step(wx, q, y, m, alpha, i, b, C, active)
        w += coef[:, None] * x
        viol = torch.maximum(viol, v)
    return viol


def _cd_epoch_sparse(xh, xs, y, m, q, alpha, w, b, C, active):
    """:func:`_cd_epoch` on blocked-CSR rows: w·x is the gather of w at
    the row's ids times its values, one float32 sum over the slots; the
    update scatter-adds Δ·y·v at the ids (padding slots add 0). ``q``
    (L, n) holds Q_ii."""
    home, shared = _blocks(xh, xs, y.shape[0], y.device)
    viol = torch.zeros_like(b)
    for i in range(y.shape[1]):
        rows = _rows(xh, xs, i, home, shared)
        idx, val = rows.indices.long(), rows.values.float()
        wx = (w.gather(1, idx) * val).sum(-1)
        coef, v = _cd_step(wx, q[:, i], y, m, alpha, i, b, C, active)
        w.scatter_add_(1, idx, coef[:, None] * val)
        viol = torch.maximum(viol, v)
    return viol


def cd_solve_ref(xh: torch.Tensor, xs: torch.Tensor, y: torch.Tensor,
                 m: torch.Tensor, *, C, tol, max_epochs):
    """The whole dual-CD solve of L jobs (the plain ``cd_solve``).

    xh (n_home, per, d) home rows, xs (S, d) rows shared by every job
    or (B, S, d) blocks (see the module's note); job l solves over the
    augmented rows ``[xh[l % n_home]; its shared block]`` with
    labels/mask y, m (L, per + S), and its own C, tol and max_epochs
    (numbers or (L,) tensors). Each job runs at least one epoch (when
    its ``max_epochs`` > 0) and stops once its own violation ≤ its
    ``tol`` — a job that stops is frozen while the others go on, as
    ``vmap`` of the reference's ``while_loop`` behaves.

    → alpha (L, n) f32, w (L, d) f32, b (L,) f32, epochs (L,) int32,
    viol (L,) f32.
    """
    return solve_with(xh, xs, y, m, C=C, tol=tol, max_epochs=max_epochs)


def solve_with(xh, xs, y, m, *, C, tol, max_epochs, dots=_dots):
    """:func:`cd_solve_ref` with the row dot products taken by
    ``dots(w, x) → (w·x, x·x)`` (an emulation of a kernel's sum order
    passes its own)."""
    return _solve(xh.shape[-1], y, m, tol, max_epochs,
                  lambda a, w, b, y, m, act: _cd_epoch(xh, xs, y, m, a, w, b,
                                                       C, act, dots))


def sparse_sq_norms(values: torch.Tensor) -> torch.Tensor:
    """Σ v² over the last axis of blocked-CSR values, as the reference's
    jitted ``sparse.row_sq_norms`` rounds it: the sum in the values' dtype
    (a bf16 Σ v² is bf16), taken in float32 over float32 products (XLA
    keeps the bf16 v² unrounded inside the fused reduction; a bf16 v² is
    exact in float32). The sum goes in the fixed order of
    ``cd_solve_sparse.cu`` (lane k of a warp adds the slots k, k + 32, …
    in turn, then the lanes pair up by xor 16, 8, 4, 2, 1), so that the
    kernel and this version round to the same bf16. → float32 (…,)."""
    dt = values.dtype
    p = values.float() * values.float()
    cap = p.shape[-1]
    p = torch.nn.functional.pad(p, (0, -cap % 32)).unflatten(-1, (-1, 32))
    s = p[..., 0, :]
    for k in range(1, p.shape[-2]):
        s = s + p[..., k, :]
    while s.shape[-1] > 1:
        s = s[..., :s.shape[-1] // 2] + s[..., s.shape[-1] // 2:]
    return s[..., 0].to(dt).float()


def cd_solve_sparse_ref(xh, xs, y: torch.Tensor, m: torch.Tensor, *,
                        C, tol, max_epochs):
    """:func:`cd_solve_ref` on blocked-CSR rows (the plain
    ``cd_solve/sparse``): xh ``SparseRows`` (n_home, per, d), xs
    ``SparseRows`` (S, d) or (B, S, d) of one nnz_cap, blocks as there.
    Values are cast to float32 for
    w·x and the update, as the reference does (``svm.py:183-185``);
    Q_ii = Σ v² + 1 with Σ v² in the values' dtype
    (:func:`sparse_sq_norms`, ``svm.py:165``), 1 on masked rows. The
    same outputs, stop rule and frozen jobs."""
    home, shared = _blocks(xh, xs, y.shape[0], y.device)
    qh = sparse_sq_norms(xh.values)
    qs = sparse_sq_norms(_shared3(xs).values)
    q = torch.cat([qh[home], qs[shared]], 1)
    q = torch.where(m.float() > 0, q + 1.0, 1.0)
    return _solve(xh.shape[-1], y, m, tol, max_epochs,
                  lambda a, w, b, y, m, act: _cd_epoch_sparse(
                      xh, xs, y, m, q, a, w, b, C, act))


def _solve(d: int, y, m, tol, max_epochs, epoch):
    """The epoch loop with the reference's stop rule over the L jobs of
    y (L, n) on rows of width d, each with its own tol and max_epochs
    (numbers or (L,)); ``epoch(α, w, b, y, m, active)`` runs one epoch
    in place and returns its violation per job."""
    L = y.shape[0]
    dev = y.device
    tol = _per_job(tol, L, dev)
    max_epochs = _per_job(max_epochs, L, dev, torch.int32)
    y, m = y.float(), m.float()
    alpha = torch.zeros(y.shape, dtype=torch.float32, device=dev)
    w = torch.zeros((L, d), dtype=torch.float32, device=dev)
    b = torch.zeros((L,), dtype=torch.float32, device=dev)
    viol = torch.full((L,), math.inf, dtype=torch.float32, device=dev)
    t = torch.zeros((L,), dtype=torch.int32, device=dev)
    while True:
        active = (t < max_epochs) & ((t == 0) | (viol > tol))
        if not bool(active.any()):
            break
        ep = epoch(alpha, w, b, y, m, active.float())
        viol = torch.where(active, ep, viol)
        t += active.int()
    return alpha, w, b, t, viol


def cd_epoch_ref(X: torch.Tensor, *, alpha, w, b, y, mask, C: float = 1.0):
    """One dual-CD epoch of one job from a given state (X (n, d)).

    → (alpha (n,), w (d,), b ()) updated, all float32.
    """
    a = alpha.float().clone()[None]
    wv = w.float().clone()[None]
    bv = torch.as_tensor(b, dtype=torch.float32, device=X.device).reshape(1).clone()
    xs = X.new_zeros((0, X.shape[1]))
    one = torch.ones((1,), dtype=torch.float32, device=X.device)
    _cd_epoch(X[None], xs, y.float()[None], mask.float()[None], a, wv, bv,
              C, one)
    return a[0], wv[0], bv[0]


def hinge_scores_ref(X, W: torch.Tensor, b: torch.Tensor,
                     y: torch.Tensor, mask: torch.Tensor,
                     chunk_rows: int = 4096):
    """Fused risk evaluation (paper eq. 6/7), the plain ``hinge_scores``
    of both formats.

    X (n, d) rows or ``SparseRows`` (whose product gathers Wᵀ at a row's
    ids and sums over its slots, ``SparseRows.__matmul__``), W (L, d),
    b (L,), y (n,), mask (n,) →
      losses (L,): Σ_i mask_i · max(0, 1 − y_i·(x_i·w_l + b_l))
      count (): Σ mask
    Rows go through in chunks so a bf16 X is never copied whole to f32.
    """
    Wf = W.float()
    bf = b.float()
    losses = torch.zeros(W.shape[0], dtype=torch.float32, device=X.device)
    for i in range(0, X.shape[0], chunk_rows):
        s = X[i:i + chunk_rows].to(dtype=torch.float32) @ Wf.T + bf[None, :]
        h = torch.clamp(1.0 - y[i:i + chunk_rows].float()[:, None] * s,
                        min=0.0)
        losses += (h * mask[i:i + chunk_rows].float()[:, None]).sum(0)
    return losses, mask.float().sum()


def _kernel_transform(dots, xx, zz, kind: str, gamma: float, coef0: float,
                      degree: int) -> torch.Tensor:
    """The fused epilogue of the Gram kernels on float32 dot products."""
    if kind == "linear":
        return dots
    if kind == "poly":
        return (gamma * dots + coef0) ** int(degree)
    if kind == "rbf":
        sq = xx[:, None] + zz[None, :] - 2.0 * dots
        return torch.exp(-gamma * torch.clamp(sq, min=0.0))
    raise ValueError(f"unknown kernel {kind!r}")


def gram_ref(X: torch.Tensor, Z: torch.Tensor, kind: str = "linear",
             gamma: float = 1.0, coef0: float = 0.0,
             degree: int = 3) -> torch.Tensor:
    """K = k(X, Z) (n, d) × (m, d) → (n, m) float32, from float32-cast
    rows (products, sums and the rbf norms, as ``gram.py:40-77``)."""
    Xf, Zf = X.float(), Z.float()
    xx = zz = None
    if kind == "rbf":
        xx = (Xf * Xf).sum(-1)
        zz = (Zf * Zf).sum(-1)
    return _kernel_transform(Xf @ Zf.T, xx, zz, kind, gamma, coef0, degree)


def sparse_gram_ref(X, Z, kind: str = "linear", gamma: float = 1.0,
                    coef0: float = 0.0, degree: int = 3) -> torch.Tensor:
    """K = k(X, Z) for blocked-CSR ``SparseRows`` (either may be dense)
    → (n, m) float32, from float32-cast values: dots by the chunked
    scatter-densify gather of :func:`repro_torch.sparse.cross_dots`,
    norms Σ v² (distinct in-row indices assumed)."""
    X = X.to(dtype=torch.float32) if sparse_rows.is_sparse(X) else X.float()
    Z = Z.to(dtype=torch.float32) if sparse_rows.is_sparse(Z) else Z.float()
    xx = zz = None
    if kind == "rbf":
        xx, zz = sparse_rows.row_sq_norms(X), sparse_rows.row_sq_norms(Z)
    return _kernel_transform(sparse_rows.cross_dots(X, Z), xx, zz, kind,
                             gamma, coef0, degree)


def sparse_gram_scores_ref(X, Z, coef: torch.Tensor, b: torch.Tensor,
                           kind: str = "linear", gamma: float = 1.0,
                           coef0: float = 0.0,
                           degree: int = 3) -> torch.Tensor:
    """S = k(X, Zᵀ)·coefᵀ + b (the plain ``sparse_gram_scores``): X (n, d)
    query rows; Z rows or a ``(home (1, per, d), shared)`` pair; coef
    (L, Z's rows), b (L,), one dtype. :func:`sparse_gram_ref` over
    chunks of query rows of at most 2²⁸ K entries (~1 GB), then
    ``K.to(coef.dtype) @ coefᵀ + b``. → (n, L) in coef's dtype."""
    if isinstance(Z, tuple):
        Z = sparse_rows.rows_concat(Z[0][0], Z[1])
    n = X.shape[0]
    out = torch.empty((n, coef.shape[0]), dtype=coef.dtype,
                      device=coef.device)
    step = max(1, (1 << 28) // max(Z.shape[0], 1))
    for q0 in range(0, n, step):
        K = sparse_gram_ref(X[q0:q0 + step], Z, kind, gamma, coef0, degree)
        out[q0:q0 + step] = K.to(coef.dtype) @ coef.T
    return out + b


def cd_solve_gram_ref(K: torch.Tensor, y: torch.Tensor, m: torch.Tensor, *,
                      C, tol, max_epochs):
    """The Gram dual-CD solve of L jobs (the plain ``cd_solve_gram``).

    K (L, n, n) without the bias ``+1``; y, m (L, n). Every operation
    runs in K's dtype as in ``fit_binary_kernel`` (``svm.py:258-308``):
    Q = (y yᵀ)·(K + 1)·(m mᵀ), Q_ii → 1 on masked rows, g = −m, and per
    row i: α_i ← clip(α_i − g_i/Q_ii, 0, C), g += Δ·Q[:, i]. Each job
    runs at least one epoch (when its ``max_epochs`` > 0) and stops once
    its own violation ≤ its ``tol``; a stopped job is frozen while the
    others go on, as ``vmap`` of the reference's ``while_loop`` behaves.
    C, tol and max_epochs are numbers or (L,) tensors; C and tol are
    taken in K's dtype, a tensor's float32 values rounded to it.

    → alpha (L, n), epochs (L,) int32, viol (L,), in K's dtype.
    """
    L, n, _ = K.shape
    dt, dev = K.dtype, K.device
    y, m = y.to(dt), m.to(dt)
    Cv, tolv = (v.to(dt).expand(L) if isinstance(v, torch.Tensor)
                else torch.tensor(v, dtype=dt, device=dev).expand(L)
                for v in (C, tol))
    max_epochs = _per_job(max_epochs, L, dev, torch.int32)
    Q = (y[:, :, None] * y[:, None, :]) * (K + 1.0)
    Q = Q * (m[:, :, None] * m[:, None, :])
    qdiag = torch.where(m > 0, torch.diagonal(Q, dim1=1, dim2=2),
                        torch.ones((), dtype=dt, device=dev))
    alpha = torch.zeros((L, n), dtype=dt, device=dev)
    g = -torch.ones((L, n), dtype=dt, device=dev) * m
    viol = torch.full((L,), math.inf, dtype=dt, device=dev)
    t = torch.zeros((L,), dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    while True:
        active = (t < max_epochs) & ((t == 0) | (viol > tolv))
        if not bool(active.any()):
            break
        ep = torch.zeros((L,), dtype=dt, device=dev)
        for i in range(n):
            gi, ao, mi = g[:, i], alpha[:, i], m[:, i]
            pg = torch.where(ao <= 0.0, torch.minimum(gi, zero),
                             torch.where(ao >= Cv, torch.maximum(gi, zero),
                                         gi))
            an = torch.clamp(ao - gi / qdiag[:, i], min=zero, max=Cv)
            delta = torch.where(active, (an - ao) * mi, zero)
            alpha[:, i] = ao + delta
            g = g + delta[:, None] * Q[:, :, i]
            ep = torch.maximum(ep, pg.abs() * mi)
        viol = torch.where(active, ep, viol)
        t += active.int()
    return alpha, t, viol


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         valid_len: torch.Tensor) -> torch.Tensor:
    """Single-token GQA decode attention (the plain ``flash_decode``).

    q (B, H, hd); k, v (B, KV, S, hd); valid_len () int32 → (B, H, hd)
    in q's dtype. Query head h = kv·G + g (G = H / KV) reads KV head kv.
    As the Pallas kernel (``decode_attention.py:24-56``), everything runs
    in float32: q·kᵀ/√hd, positions ≥ ``valid_len`` set to −1e30, the
    softmax, the sum over V; then one cast to q's dtype. This is
    ``repro.kernels.ref.decode_attention_ref`` on float32-cast inputs.
    With ``valid_len`` = 0 every score is −1e30 and the result is the
    mean of V over all S slots, as in the reference.
    """
    B, H, hd = q.shape
    KV, S = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, KV, H // KV, hd) * (1.0 / hd ** 0.5)
    scores = torch.einsum("bkgh,bkth->bkgt", qg, k.float())
    pos = torch.arange(S, device=q.device)
    scores = torch.where(pos < valid_len, scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgt,bkth->bkgh", probs, v.float())
    return out.reshape(B, H, hd).to(q.dtype)
