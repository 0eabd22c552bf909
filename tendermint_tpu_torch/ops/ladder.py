"""The Ed25519 ladders: plain PyTorch versions and CUDA launchers.

Replaces the three Pallas kernels of `tendermint_tpu/ops/ladder_pallas.py`:

  verify      <- verify_pallas (`_verify_kernel` + `_ladder_tail`): the
                 fused cofactorless verify, decompressing A in the kernel.
  verify_pre  <- verify_pallas_pre (`_verify_kernel_pre` + the same
                 tail): the ladder fed with cached canonical bytes of
                 (-A).x and A.y plus the validity mask.
  sign_rb     <- sign_pallas_rB (`_sign_kernel`): enc(r*B) for the nonces
                 of batched signing, the fixed-base subset of the ladder.

`verify_plain` / `verify_pre_plain` follow the Pallas kernels' exact
schedule (16-entry table of -A with T pre-multiplied by 2d; msb-first
Horner over the low `n_windows` 4-bit windows; per window three T-less
doublings, one doubling with T, an affine add from the table of B and a
T-less add from the table of -A; digits zeroed where A is invalid; the
curve25519 addition chains for the inverse and the square root;
canonical encode, then compare with R). `sign_rb_plain` is the same
window loop with the fixed-base add only, then the encode. They are what
the CPU tests run and what `chip_smoke.py` holds the kernels against on
the card. The sign kernel itself runs another schedule, a fixed-base comb
over `_comb_np`'s table (csrc/fe25519.cuh, `sign_rb_comb`), so its plain
version is an independent check of it.

`verify` / `verify_pre` / `sign_rb` launch the CUDA kernels of
`csrc/ladder.cu` when their tensors are on a CUDA device and take the
plain version only when they are on the CPU. Nothing falls back: a
failed build or launch raises.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from tendermint_tpu_torch.ops import _build
from tendermint_tpu_torch.ops import curve
from tendermint_tpu_torch.ops import field as fe

N_WINDOWS = 64

# ---------------------------------------------------------------------------
# Constant tables (the state `convert.state_from_jax` carries across)
# ---------------------------------------------------------------------------


def _s_table_np() -> np.ndarray:
    """Affine k*B for k = 0..15 as int32[16, 3, 20]: (X, Y, T*2d), Z == 1."""
    out = np.zeros((16, 3, fe.NLIMBS), np.int32)
    for k, (x, y) in enumerate(curve._B_MULT_INTS):
        out[k, 0] = fe.to_limbs(x)
        out[k, 1] = fe.to_limbs(y)
        out[k, 2] = fe.to_limbs(x * y % fe.P * fe.D2_INT % fe.P)
    return out


def _consts_np() -> np.ndarray:
    """int32[4, 20]: D, D2, SQRT_M1, ONE."""
    return np.stack([fe.D, fe.D2, fe.SQRT_M1, fe.ONE]).astype(np.int32)


_tables_lock = threading.Lock()
_tables = {"s_table": _s_table_np(), "consts": _consts_np()}
_device_tables: dict = {}  # (name, device) -> tensor


def install_tables(s_table, consts, device=None) -> None:
    """Replace the s-table (int32[16, 3, 20]) and constants (int32[4, 20])
    that both the plain versions and the kernels read; with `device`,
    copy them there now."""
    s_table = np.ascontiguousarray(s_table, dtype=np.int32)
    consts = np.ascontiguousarray(consts, dtype=np.int32)
    if s_table.shape != (16, 3, fe.NLIMBS) or consts.shape != (4, fe.NLIMBS):
        raise ValueError(f"bad table shapes {s_table.shape}, {consts.shape}")
    with _tables_lock:
        _tables["s_table"] = s_table.copy()
        _tables["consts"] = consts.copy()
        _device_tables.clear()
    if device is not None:
        _s_table(torch.device(device))
        _consts(torch.device(device))
        if torch.device(device).type == "cuda":
            _kernel_consts(torch.device(device))
            _comb(torch.device(device))


def tables() -> tuple:
    """Copies of the installed (s_table, consts)."""
    with _tables_lock:
        return _tables["s_table"].copy(), _tables["consts"].copy()


def _on_device(name: str, device: torch.device, build) -> torch.Tensor:
    key = (name, device)
    with _tables_lock:
        t = _device_tables.get(key)
        if t is None:
            t = build().to(device)
            if t.is_cuda:  # cached for every stream: wait for the copy
                torch.cuda.current_stream(t.device).synchronize()
            _device_tables[key] = t
        return t


def _s_table(device) -> torch.Tensor:
    return _on_device("s_table", device,
                      lambda: torch.from_numpy(_tables["s_table"].copy()))


def _consts(device) -> torch.Tensor:
    return _on_device("consts", device,
                      lambda: torch.from_numpy(_tables["consts"].copy()))


def _limbs25(value: int) -> list:
    """Python int -> 10 limbs of radix 2^25.5 (26, 25, 26, ... bits), the
    kernel's representation, reduced mod p."""
    value %= fe.P
    out = []
    for i in range(10):
        bits = 25 if i & 1 else 26
        out.append(value & ((1 << bits) - 1))
        value >>= bits
    return out


def _kernel_consts(device) -> torch.Tensor:
    """The installed tables in the kernel's layout: int32[51, 10] rows
    k*3 + c for s-table entry k, component c, then D, D2, SQRT_M1."""
    def build():
        s_table, consts = _tables["s_table"], _tables["consts"]
        rows = [_limbs25(fe.from_limbs(s_table[k, c]))
                for k in range(16) for c in range(3)]
        rows += [_limbs25(fe.from_limbs(consts[i])) for i in range(3)]
        return torch.tensor(rows, dtype=torch.int32)
    return _on_device("kernel_consts", device, build)


COMB_ROWS = 65   # windows 0..63, and the carry out of window 63


def _dbl_ints(pt: tuple) -> tuple:
    """2 * (X, Y, Z) on the curve, projective, in Python ints: the
    doubling of RFC 8032 section 5.1.4 (a = -1; it needs no curve
    constant)."""
    P = fe.P
    X, Y, Z = pt
    A, B = X * X % P, Y * Y % P
    C = 2 * Z * Z % P
    H = A + B
    E = H - (X + Y) * (X + Y)
    G = A - B
    F = C + G
    return E * F % P, G * H % P, F * G % P


def _comb_np(s_table, consts) -> np.ndarray:
    """The sign kernel's fixed-base comb as int32[65, 8, 3, 10]: entry
    [w, j - 1] is j * 16^w * B, affine, as (y - x, y + x, 2d x y) in the
    kernel's radix. Row 0 is entries 1..8 of `s_table` (the layout of
    `_s_table_np`); each next row is the one before doubled four times, in
    Python ints; 2d is row 1 of `consts`. So the comb follows whatever
    tables are installed."""
    P = fe.P
    d2 = fe.from_limbs(consts[1]) % P
    pts = [tuple(fe.from_limbs(s_table[j, c]) % P for c in (0, 1)) + (1,)
           for j in range(1, 9)]
    out = np.empty((COMB_ROWS, 8, 3, 10), np.int32)
    for w in range(COMB_ROWS):
        for j, (X, Y, Z) in enumerate(pts):
            zi = pow(Z, P - 2, P)
            x, y = X * zi % P, Y * zi % P
            out[w, j] = [_limbs25(y - x), _limbs25(y + x),
                         _limbs25(d2 * x * y)]
        for _ in range(4):
            pts = [_dbl_ints(pt) for pt in pts]
    return out


def _comb(device) -> torch.Tensor:
    """`_comb_np` of the installed tables, on `device`."""
    return _on_device("comb", device, lambda: torch.from_numpy(
        _comb_np(_tables["s_table"], _tables["consts"])))


# ---------------------------------------------------------------------------
# Digits
# ---------------------------------------------------------------------------

def _digits4(bits):
    """int[..., 256] little-endian bits -> int32[..., 64] 4-bit windows
    (batch first; the Pallas helper returns them transposed)."""
    b = bits.reshape(bits.shape[:-1] + (64, 4)).to(torch.int32)
    return b[..., 0] + 2 * b[..., 1] + 4 * b[..., 2] + 8 * b[..., 3]


def digits_from_bytes(b_u8):
    """uint8[..., 32] little-endian scalar -> int32[..., 64] windows:
    window w is the low nibble of byte w//2 for even w, else the high."""
    b = b_u8.to(torch.int32)
    return torch.stack([b & 15, b >> 4], dim=-1).reshape(
        b.shape[:-1] + (64,))


# ---------------------------------------------------------------------------
# Plain versions (the Pallas schedule, batch first)
# ---------------------------------------------------------------------------

def _sqn(x, n: int):
    for _ in range(n):
        x = fe.square(x)
    return x


def _chain_250(z):
    """(z^(2^250-1), z^11): the curve25519 addition chain's shared
    prefix, 249 squarings and 9 multiplications."""
    z2 = fe.square(z)
    z9 = fe.mul(z, _sqn(z2, 2))
    z11 = fe.mul(z2, z9)
    z_5_0 = fe.mul(z9, fe.square(z11))
    z_10_0 = fe.mul(_sqn(z_5_0, 5), z_5_0)
    z_20_0 = fe.mul(_sqn(z_10_0, 10), z_10_0)
    z_40_0 = fe.mul(_sqn(z_20_0, 20), z_20_0)
    z_50_0 = fe.mul(_sqn(z_40_0, 10), z_10_0)
    z_100_0 = fe.mul(_sqn(z_50_0, 50), z_50_0)
    z_200_0 = fe.mul(_sqn(z_100_0, 100), z_100_0)
    z_250_0 = fe.mul(_sqn(z_200_0, 50), z_50_0)
    return z_250_0, z11


def _inv(z):
    """z^(p-2) = z^(2^255-21)."""
    z_250_0, z11 = _chain_250(z)
    return fe.mul(_sqn(z_250_0, 5), z11)


def _pow_p58(z):
    """z^((p-5)/8) = z^(2^252-3)."""
    z_250_0, _ = _chain_250(z)
    return fe.mul(_sqn(z_250_0, 2), z)


def _one_like(x):
    return fe.const("ONE", x.device).expand(x.shape)


def _pt_add_tbl(p, q, want_t: bool = True):
    """p + q for a table point q = (X2, Y2, Z2 or None, Td2) whose T is
    pre-multiplied by 2d; Z2 None means affine (Z2 == 1)."""
    X1, Y1, Z1, T1 = p
    X2, Y2, Z2, Td2 = q
    A = fe.mul(fe.sub(Y1, X1), fe.sub(Y2, X2))
    B = fe.mul(fe.add(Y1, X1), fe.add(Y2, X2))
    C = fe.mul(T1, Td2)
    Dv = fe.mul_small(Z1 if Z2 is None else fe.mul(Z1, Z2), 2, passes=1)
    E = fe.sub(B, A)
    F = fe.sub(Dv, C)
    G = fe.add(Dv, C)
    H = fe.add(B, A)
    return (fe.mul(E, F), fe.mul(G, H), fe.mul(F, G),
            fe.mul(E, H) if want_t else None)


def _pt_double(p, want_t: bool = True):
    X1, Y1, Z1 = p[:3]
    A = fe.square(X1)
    B = fe.square(Y1)
    C = fe.mul_small(fe.square(Z1), 2, passes=1)
    E = fe.sub(fe.sub(fe.square(fe.add(X1, Y1)), A), B)
    G = fe.sub(B, A)
    F = fe.sub(G, C)
    H = fe.sub(fe.sub(torch.zeros_like(A), A), B)
    return (fe.mul(E, F), fe.mul(G, H), fe.mul(F, G),
            fe.mul(E, H) if want_t else None)


def _ladder_tail(ok, a_neg, rb, dig_s, dig_h, n_windows: int):
    """Everything after decompression, shared by both plain versions:
    table build, the Straus-w4 ladder, affine conversion, canonical
    encode and the compare with R. Returns bool[N]."""
    n = ok.shape[0]
    device = ok.device
    xn, y, one, t = a_neg
    d2 = _consts(device)[1]
    lanes = torch.arange(n, device=device)
    h_table = [(torch.zeros_like(xn), one, one, torch.zeros_like(xn)),
               (xn, y, one, fe.mul(t, d2))]
    for k in range(2, 16):
        if k % 2 == 0:
            x3, y3, z3, t3 = _pt_double(h_table[k // 2])
        else:
            x3, y3, z3, t3 = _pt_add_tbl(h_table[k - 1], (xn, y, None, t))
        h_table.append((x3, y3, z3, fe.mul(t3, d2)))
    h_stack = [torch.stack([e[c] for e in h_table]) for c in range(4)]
    s_tab = _s_table(device)
    dig_s = torch.where(ok[:, None], dig_s, 0).long()
    dig_h = torch.where(ok[:, None], dig_h, 0).long()

    acc = (torch.zeros_like(xn), one, one)
    for w in range(n_windows - 1, -1, -1):
        for _ in range(3):
            acc = _pt_double(acc, want_t=False)
        acc = _pt_double(acc, want_t=True)
        s_sel = s_tab[dig_s[:, w]]                      # [N, 3, 20]
        acc = _pt_add_tbl(acc, (s_sel[:, 0], s_sel[:, 1], None, s_sel[:, 2]))
        dh = dig_h[:, w]
        acc = _pt_add_tbl(acc, tuple(h[dh, lanes] for h in h_stack),
                          want_t=False)
    X, Y, Z = acc[:3]
    zi = _inv(Z)
    by = fe.to_bytes(fe.mul(Y, zi))
    sign = fe.to_bytes(fe.mul(X, zi))[:, 0] & 1
    enc = torch.cat([by[:, :31], (by[:, 31] | (sign << 7))[:, None]], dim=1)
    return ok & (enc == rb).all(dim=1)


def verify_plain(pk, rb, dig_s, dig_h, n_windows: int = N_WINDOWS):
    """Plain version of the fused kernel. pk, rb uint8[N, 32]; dig_s,
    dig_h int32[N, 64] windows. Returns bool[N]."""
    device = pk.device
    consts = _consts(device)
    d_c, sqrt_m1 = consts[0], consts[2]
    y, sign = fe.from_bytes(pk)
    one = _one_like(y)
    y2 = fe.square(y)
    u = fe.sub(y2, one)
    v = fe.add(fe.mul(y2, d_c), one)
    v3 = fe.mul(fe.square(v), v)
    v7 = fe.mul(fe.square(v3), v)
    r = fe.mul(fe.mul(u, v3), _pow_p58(fe.mul(u, v7)))
    check_b = fe.to_bytes(fe.mul(v, fe.square(r)))
    ok_direct = (check_b == fe.to_bytes(u)).all(dim=1)
    ok_flipped = (check_b == fe.to_bytes(fe.neg(u))).all(dim=1)
    x = fe.select(ok_flipped & ~ok_direct, fe.mul(r, sqrt_m1), r)
    ok = ok_direct | ok_flipped
    x_b = fe.to_bytes(x)
    ok = ok & ~((x_b == 0).all(dim=1) & (sign == 1))
    flip = ((x_b[:, 0] & 1) == 1) != (sign == 1)
    x = fe.select(flip, fe.neg(x), x)
    xn = fe.neg(x)
    return _ladder_tail(ok, (xn, y, one, fe.mul(xn, y)), rb, dig_s, dig_h,
                        n_windows)


def verify_pre_plain(xnb, yb, ok, rb, dig_s, dig_h,
                     n_windows: int = N_WINDOWS):
    """Plain version of the predecompressed kernel: xnb, yb are the
    canonical bytes of (-A).x and A.y (uint8[N, 32]), ok bool[N]."""
    xn, _ = fe.from_bytes(xnb)
    y, _ = fe.from_bytes(yb)
    return _ladder_tail(ok.bool(), (xn, y, _one_like(y), fe.mul(xn, y)),
                        rb, dig_s, dig_h, n_windows)


def sign_rb_plain(dig_r, n_windows: int = N_WINDOWS):
    """Plain version of the sign kernel: enc(r*B) as uint8[N, 32] for
    int32[N, 64] windows of scalars r, over the low `n_windows` windows."""
    s_tab = _s_table(dig_r.device)
    dig_r = dig_r.long()
    zero = torch.zeros(dig_r.shape[0], fe.NLIMBS, dtype=torch.int32,
                       device=dig_r.device)
    one = _one_like(zero)
    acc = (zero, one, one)
    for w in range(n_windows - 1, -1, -1):
        for _ in range(3):
            acc = _pt_double(acc, want_t=False)
        acc = _pt_double(acc, want_t=True)
        s_sel = s_tab[dig_r[:, w]]                      # [N, 3, 20]
        acc = _pt_add_tbl(acc, (s_sel[:, 0], s_sel[:, 1], None, s_sel[:, 2]),
                          want_t=False)
    X, Y, Z = acc[:3]
    zi = _inv(Z)
    by = fe.to_bytes(fe.mul(Y, zi))
    sign = fe.to_bytes(fe.mul(X, zi))[:, 0] & 1
    return torch.cat([by[:, :31], (by[:, 31] | (sign << 7))[:, None]], dim=1)


def field_muls(kernel: str, n_windows: int = N_WINDOWS) -> int:
    """Field multiplications (squarings included) one lane runs: one
    verify ("verify", "verify_pre") on this schedule, or one r*B on the
    sign kernel's comb ("sign_rb") or on the windowed schedule its plain
    version keeps ("sign_rb_plain")."""
    chain = 259                               # _chain_250
    inv = chain + 5 + 1                       # _inv
    dbl_t, dbl, add_aff_t, add_z = 8, 7, 7, 7
    if kernel == "sign_rb":
        # per window one mixed add with T (A, B, C, then X, Y, Z, T), the
        # carry's add without T (6), the inverse, then x and y:
        # 64 x 7 + 6 + 265 + 2 = 721 at 64 windows
        return n_windows * add_aff_t + (add_aff_t - 1) + inv + 2
    if kernel == "sign_rb_plain":
        # per window three doublings without T, one with T, the affine
        # add without T: 64 x 35 + 265 + 2 = 2507 at 64 windows
        return n_windows * (3 * dbl + dbl_t + add_aff_t - 1) + inv + 2
    if kernel not in ("verify", "verify_pre"):
        raise ValueError(f"unknown kernel {kernel!r}")
    full = kernel == "verify"
    tail = (1 + 7 * (dbl_t + 1) + 7 * (add_aff_t + 1)     # td2 + h-table
            + n_windows * (3 * dbl + dbl_t + add_aff_t + add_z)
            + inv + 2)                        # then x and y
    # decompress: y^2, y^2 d, v^3, v^7, u v^3, u v^7, the p58 chain,
    # the product with it, v r^2, r sqrt(-1), then (-x) y
    head = 1 + 1 + 2 + 2 + 1 + 1 + (chain + 3) + 1 + 2 + 1 + 1 if full else 1
    return head + tail


def bound_field_muls(kernel: str, n: int, n_windows: int = N_WINDOWS) -> int:
    """Field products of a launch over n lanes that its roofline bound is
    taken from.

    "sign_rb": the least work of enc(r*B) for a batch of n scalars over
    the comb's table (signed 4-bit windows; a larger table would cut the
    adds further and is not counted). Each scalar needs its window adds
    and the carry's (64 x 7 + 6), then x and y (2), each from 1/Z. One
    inverse serves the whole batch by Montgomery's trick: n - 1 prefix
    products, the inverse (265), two products a scalar on the way back,
    3 (n - 1) + 265 in all. So n (64 x 7 + 6 + 2 + 3) + 262 = 459 n + 262
    at 64 windows, 459.016 a scalar at 16384, where the kernel's own
    schedule (an inverse a scalar) runs 721. The only squarings left are
    the shared inverse's 254, counted as products: under 0.02 a scalar at
    16384.

    "verify", "verify_pre": n x `field_muls`, the schedule's count, each
    signature's own inverse and square root included, squarings counted
    as products."""
    if kernel != "sign_rb":
        return n * field_muls(kernel, n_windows)
    inv = 259 + 5 + 1
    return n * (field_muls(kernel, n_windows) - inv + 3) + inv - 3


# ---------------------------------------------------------------------------
# CUDA launchers
# ---------------------------------------------------------------------------

#: kernel launches per wrapper, counted only where the kernel launches
launches = {"verify": 0, "verify_pre": 0, "sign_rb": 0}


def _check_rows(name, t, device, dtype=torch.uint8, width=32, n=None):
    shape = (n, width) if width else (n,)
    if t.device != device or t.dtype != dtype or not t.is_contiguous() \
            or tuple(t.shape) != shape or t.data_ptr() % 16:
        raise ValueError(
            f"{name}: want contiguous 16-byte aligned {dtype} {shape} on "
            f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _launch(name, fn_name, rows, n_windows, out_width=None,
            table=_kernel_consts):
    """Check the inputs, allocate the output, launch `fn_name` on the
    current stream with `table(device)` (the kernels' constants, or the
    sign kernel's comb), count. The output is int32[N] verdicts, returned
    as bool[N], or with `out_width` uint8[N, out_width] bytes."""
    device = rows[0].device
    n = rows[0].shape[0]
    if not 1 <= n_windows <= N_WINDOWS:
        raise ValueError(f"n_windows must be 1..64, got {n_windows}")
    for i, t in enumerate(rows):
        is_ok = name == "verify_pre" and i == 2
        _check_rows(f"{name} arg {i}", t, device, n=n,
                    width=None if is_ok else 32)
    if out_width is None:
        out = torch.empty(n, dtype=torch.int32, device=device)
    else:
        out = torch.empty((n, out_width), dtype=torch.uint8, device=device)
    if n == 0:
        return out if out_width else out.bool()
    consts = table(device)
    lib = _build.ladder_lib()
    stream = torch.cuda.current_stream(device)
    with torch.cuda.device(device):
        err = getattr(lib, fn_name)(
            *[ctypes.c_void_p(t.data_ptr()) for t in rows],
            ctypes.c_void_p(consts.data_ptr()),
            ctypes.c_void_p(out.data_ptr()),
            ctypes.c_int(n), ctypes.c_int(n_windows),
            ctypes.c_void_p(stream.cuda_stream))
    if err != 0:
        raise RuntimeError(
            f"{fn_name} launch failed: {_build.cuda_error_string(lib, err)}")
    launches[name] += 1
    return out if out_width else out != 0


def verify(pk, rb, s_bytes, h_bytes, n_windows: int = N_WINDOWS):
    """Fused verify: bool[N] verdicts of enc(s*B - h*A) == R with A
    decompressed from pk. pk, rb, s_bytes, h_bytes: uint8[N, 32] on one
    device (s, h the packed little-endian scalars)."""
    if pk.device.type == "cpu":
        return verify_plain(pk, rb, digits_from_bytes(s_bytes),
                            digits_from_bytes(h_bytes), n_windows)
    if pk.device.type != "cuda":
        raise ValueError(f"verify runs on cuda or cpu, not {pk.device}")
    return _launch("verify", "tm_ladder_verify",
                   [pk, rb, s_bytes, h_bytes], n_windows)


def verify_pre(xnb, yb, ok, rb, s_bytes, h_bytes,
               n_windows: int = N_WINDOWS):
    """Predecompressed verify: xnb, yb uint8[N, 32] canonical bytes of
    (-A).x and A.y, ok bool[N] the decompression mask."""
    if xnb.device.type == "cpu":
        return verify_pre_plain(xnb, yb, ok, rb, digits_from_bytes(s_bytes),
                                digits_from_bytes(h_bytes), n_windows)
    if xnb.device.type != "cuda":
        raise ValueError(f"verify_pre runs on cuda or cpu, not {xnb.device}")
    return _launch("verify_pre", "tm_ladder_verify_pre",
                   [xnb, yb, ok.to(torch.uint8).contiguous(), rb, s_bytes,
                    h_bytes], n_windows)


def sign_rb(r_u8, n_windows: int = N_WINDOWS):
    """enc(r*B) as uint8[N, 32] for scalars r given as uint8[N, 32]
    little-endian bytes (the nonces of signing, each < L, though any 32
    bytes give (r mod 16^n_windows) * B)."""
    if r_u8.device.type == "cpu":
        return sign_rb_plain(digits_from_bytes(r_u8), n_windows)
    if r_u8.device.type != "cuda":
        raise ValueError(f"sign_rb runs on cuda or cpu, not {r_u8.device}")
    return _launch("sign_rb", "tm_ladder_sign_rb", [r_u8], n_windows,
                   out_width=32, table=_comb)
