"""The plain reference of the Monte-Carlo sweep: the frames a step draws,
the four decoders of gr-ldpc_ece535a's simulator, and the error counts.

Frames. A step of the program draws its frames from an integer key
(seed, point, step), or (seed, point, step, shard) over a mesh: the key's
words go through NumPy's ``SeedSequence`` to two 32-bit words, which seed
a ``torch.Generator`` on the device; then K random bits a frame
(``torch.randint``, int8), the codeword u = [c | d], BPSK 2u - 1 and AWGN
with N0 = 10^(-EbN0/10) from the same generator. ``draw`` makes the same
frames from the same key on the same device, with its own code
(``code.py``).

Decoders (apps/ldpc_lapack.cpp:647-666 and the library's decoders), on
rx (B, N), bit = 1 for rx >= 0:

  hard        the slicer.
  bitflip     decodeBitFlipping: a bit is set to the complement of its
              channel decision where more than M // 2 of its checks
              disagree with that decision.
  minsum      decodeLogDomainSimple: Lci = -rx; the check message is the
              row's sign product times the own sign times the least other
              |Lq|; LQ = Lci + sum of the variable's messages, bit = LQ < 0;
              Lq = LQ - own message.
  sumproduct  decodeSumProductSoft: r = -rx; the check message is
              log((1 + T) / (1 - T)), T the product of the other
              tanh(M / 2) of the row; the decision sums E + r over the
              variable's checks (bit = sum <= 0); the next message is that
              sum over the other checks.

Early exit as the reference's: min-sum and bit-flip stop a frame whose
decision satisfies H after any pass but the last; sum-product after every
pass. A stopped frame keeps its decision. ``dtype`` is the arithmetic of the
soft decoders: float32, or a lower precision for the benchmark's control.

Imports nothing of the program under test.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .code import Code

__all__ = ["generator", "draw", "decode", "counts", "syndrome_ok",
           "METHODS"]

METHODS = ("hard", "bitflip", "minsum", "sumproduct")


def generator(key, device) -> torch.Generator:
    """The generator a step of the program seeds from ``key``."""
    words = np.random.SeedSequence([int(k) for k in key]).generate_state(
        2, np.uint32)
    return torch.Generator(device=device).manual_seed(
        (int(words[0]) << 31) ^ int(words[1]))


@functools.lru_cache(maxsize=None)
def _tensor(code: Code, what: str, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(getattr(code, what), device=device)


def draw(code: Code, frames: int, key, ebn0_db: float, device):
    """(u (B, N) int8 codewords, rx (B, N) float32) of the step ``key``."""
    device = torch.device(device)
    g = generator(key, device)
    d = torch.randint(0, 2, (frames, code.K), generator=g, device=device,
                      dtype=torch.int8)
    G = _tensor(code, "G", device).to(torch.float32)
    c = torch.remainder((d.to(torch.float32) @ G.T).to(torch.int32), 2)
    u = torch.cat([c.to(torch.int8), d], dim=1)
    n0 = torch.pow(10.0, -torch.as_tensor(ebn0_db, dtype=torch.float32,
                                          device=device) / 10.0)
    noise = torch.randn(u.shape, generator=g, dtype=torch.float32,
                        device=device)
    return u, (2 * u.to(torch.float32) - 1) + torch.sqrt(n0) * noise


def syndrome_weight(v: torch.Tensor, code: Code) -> torch.Tensor:
    """Unsatisfied checks a frame of decisions v (B, N)."""
    H = _tensor(code, "H", v.device).to(torch.float32)
    return torch.remainder((v.to(torch.float32) @ H.T).to(torch.int32),
                           2).sum(1)


def syndrome_ok(v: torch.Tensor, code: Code) -> torch.Tensor:
    return syndrome_weight(v, code) == 0


def _sign(x: torch.Tensor) -> torch.Tensor:
    """The C library's sign: -1, 0 or +1."""
    return (x > 0).to(x.dtype) - (x < 0).to(x.dtype)


def _seq_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the last axis from slot 0 up, as the reference's loop."""
    acc = x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def _others_sum(x: torch.Tensor) -> torch.Tensor:
    """For each slot of the last axis the sum of the other slots, in slot
    order, as the reference's loop over a variable's other checks."""
    W = x.shape[-1]
    out = []
    for k in range(W):
        acc = torch.zeros_like(x[..., 0])
        for i in range(W):
            if i != k:
                acc = acc + x[..., i]
        out.append(acc)
    return torch.stack(out, -1)


class _Graph:
    """The code's edges on a device: check-major slots (M, Wr) and, for each
    variable, the check-major slot of each of its edges (N, Wc)."""

    def __init__(self, code: Code, device: torch.device):
        M, N = code.M, code.N
        self.chk = torch.as_tensor(code.chk, device=device)          # (M, Wr)
        self.cmask = self.chk < N
        slot = {}
        for m in range(M):
            for w, v in enumerate(code.chk[m]):
                if v < N:
                    slot[(m, int(v))] = m * code.chk.shape[1] + w
        vs = np.full(code.var.shape, M * code.chk.shape[1], np.int64)
        for v in range(N):
            for w, m in enumerate(code.var[v]):
                if m < M:
                    vs[v, w] = slot[(int(m), v)]
        self.vslot = torch.as_tensor(vs, device=device)             # (N, Wc)
        self.vmask = torch.as_tensor(code.var < M, device=device)
        # for each check-major slot, its (variable, position) in var-major
        back = np.zeros(code.chk.shape, np.int64)
        for v in range(N):
            for w, m in enumerate(code.var[v]):
                if m < M:
                    back[np.unravel_index(vs[v, w], code.chk.shape)] = (
                        v * code.var.shape[1] + w)
        self.back = torch.as_tensor(back, device=device)            # (M, Wr)

    def to_var(self, x_cm: torch.Tensor) -> torch.Tensor:
        """Check-major messages (B, M, Wr) -> var-major (B, N, Wc), pads 0."""
        flat = torch.cat([x_cm.reshape(x_cm.shape[0], -1),
                          x_cm.new_zeros(x_cm.shape[0], 1)], 1)
        return torch.where(self.vmask, flat[:, self.vslot], 0)

    def to_chk(self, x_vm: torch.Tensor) -> torch.Tensor:
        """Var-major messages (B, N, Wc) -> check-major (B, M, Wr), pads 0."""
        flat = x_vm.reshape(x_vm.shape[0], -1)
        return torch.where(self.cmask, flat[:, self.back], 0)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Per-variable values (B, N) at each check's slots (B, M, Wr)."""
        xz = torch.cat([x, x.new_zeros(x.shape[0], 1)], 1)
        return torch.where(self.cmask, xz[:, self.chk], 0)


@functools.lru_cache(maxsize=None)
def _graph(code: Code, device: torch.device) -> _Graph:
    return _Graph(code, device)


def _minsum_pass(Lq, Lci, g: _Graph):
    big = torch.tensor(float("inf"), dtype=Lq.dtype, device=Lq.device)
    beta = torch.where(g.cmask, Lq.abs(), big)
    alpha = torch.where(g.cmask, _sign(Lq), torch.ones_like(Lq))
    min1, arg = beta.min(-1, keepdim=True)
    slots = torch.arange(beta.shape[-1], device=beta.device)
    is_arg = slots == arg
    min2 = torch.where(is_arg, big, beta).amin(-1, keepdim=True)
    Lr = alpha.prod(-1, keepdim=True) * alpha * torch.where(is_arg, min2, min1)
    Lr_v = g.to_var(torch.where(g.cmask, Lr, 0))
    total = _seq_sum(Lr_v)
    LQ = Lci + total
    Lq_v = (LQ[:, :, None] - Lr_v)
    return g.to_chk(Lq_v), (LQ < 0).to(torch.int8)


def _sumproduct_pass(Mm, r, g: _Graph):
    one = torch.ones_like(Mm)
    th = torch.where(g.cmask, torch.tanh(Mm / 2), one)
    W = th.shape[-1]
    T = torch.stack([torch.prod(torch.cat([th[..., :k], th[..., k + 1:]], -1),
                                -1) for k in range(W)], -1)
    E = torch.log((1 + T) / (1 - T))
    terms = torch.where(g.vmask, g.to_var(torch.where(g.cmask, E, 0))
                        + r[:, :, None], 0)
    vhat = (_seq_sum(terms) <= 0).to(torch.int8)
    return terms, vhat


def decode(method: str, rx: torch.Tensor, code: Code, iterations: int,
           early_exit: bool = True, dtype=torch.float32):
    """(decisions (B, N) int8, passes run a frame (B,) int64)."""
    B = rx.shape[0]
    dev = rx.device
    passes = torch.full((B,), iterations, dtype=torch.int64, device=dev)
    if method == "hard":
        return (rx >= 0).to(torch.int8), torch.zeros_like(passes)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    out = None

    def settle(n, v, guard):
        nonlocal done, out
        out = v if out is None else torch.where(done[:, None], out, v)
        if early_exit and (not guard or n + 1 < iterations):
            ok = syndrome_ok(v, code) & ~done
            passes[ok] = n + 1
            done = done | ok

    if method == "bitflip":
        H = _tensor(code, "H", dev).to(torch.float32)
        y = (rx >= 0).to(torch.int32)
        ci = y
        g = _graph(code, dev)
        for n in range(iterations):
            p = torch.remainder((ci.to(torch.float32) @ H.T).to(torch.int32), 2)
            pv = torch.cat([p, p.new_zeros(B, 1)], 1)[:, torch.as_tensor(
                code.var, device=dev)]                            # (B, N, Wc)
            disagree = torch.where(g.vmask, (pv ^ ci[:, :, None])
                                   != y[:, :, None], False).sum(-1)
            new = torch.where(disagree > code.M // 2, 1 - y, ci)
            ci = torch.where(done[:, None], ci, new)
            settle(n, new.to(torch.int8), guard=True)
        return out, passes
    g = _graph(code, dev)
    r = -rx.to(dtype)
    msg = g.gather(r)
    for n in range(iterations):
        if method == "minsum":
            new, v = _minsum_pass(msg, r, g)
            msg = torch.where(done[:, None, None], msg, new)
            settle(n, v, guard=True)
        elif method == "sumproduct":
            terms, v = _sumproduct_pass(msg, r, g)
            settle(n, v, guard=False)
            new = g.to_chk(torch.where(g.vmask, _others_sum(terms), 0))
            msg = torch.where(done[:, None, None], msg, new)
        else:
            raise ValueError(f"unknown method {method!r}")
    return out, passes


def counts(v: torch.Tensor, u: torch.Tensor, code: Code) -> np.ndarray:
    """(bit, info-bit, frame, detected) errors of decisions v against the
    sent codewords u, int64."""
    wrong = v != u
    return np.array([int(wrong.sum()), int(wrong[:, code.M:].sum()),
                     int(wrong.any(1).sum()),
                     int((syndrome_weight(v, code) > 0).sum())], np.int64)
