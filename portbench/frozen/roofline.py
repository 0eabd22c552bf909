"""The least time an H100 needs to verify a window's Ed25519 signatures,
counted from the traffic's shapes and not from any kernel's schedule.

Work, in field products mod 2^255 - 19 (squarings counted as products):

* Each signature needs the double-scalar product s*B - h*A, the encode of
  the result and the compare with R. A node keeps its validator set, so
  the work that depends on a key alone is the key's, done once when the
  key is new to the run (below), as is the fixed base B's, done never.
  Both B and each kept key -A then have a comb: for each of the 32
  positions of a signed 8-bit window, the multiples 1..128 of
  256^i times the point, in the affine form (y + x, y - x, 2 d t) of 96
  bytes: 4,096 entries, 384 KiB a point, 3.9 GB for 10,000 keys. The
  product is then 64 lookups summed, with no doubling: the first lookup
  taken as the point (t = x y: 1 product), then 63 mixed additions, each
  with T (A, B, C, then X, Y, Z, T: 7) but the last (6): 441 products.
* The encode needs x = X/Z and y = Y/Z: two products, and 1/Z. The
  inverse is shared over a launch by Montgomery's trick: n - 1 prefix
  products, one inverse (a 259-product addition chain, then 6 more: 265),
  and two products a signature on the way back. That is 3 products a
  signature and 262 a launch.
* The compare of the encoding with R is bytes, no product.
* A key new to the run costs its square root, to decompress it: y^2,
  y^2 d, v^3, v^7, u v^3, u v^7, the (p - 5) / 8 chain (259 + 3), the
  product with it, v r^2, r sqrt(-1): 274 products; and its comb: 31
  doublings with T (8) from one position to the next, 127 general
  additions with T (9: the product T1 T2 and the one by 2d, 2 Z1 Z2, and
  7 others as above) a position, each entry's affine form (x, y, x y,
  2 d t: 4, and 3 for its share of one inverse) and that inverse (265):
  65,761 products.

So a window of S signatures in L launches that meets K keys new to the
run needs 446 S + 262 L + 66,035 K products.

Wider windows cut the 63 additions further (a 12-bit comb, 4.3 MB a key,
to 43) and are not counted: 10,000 keys' tables would fill half the card.
Any schedule that recomputes a key's table or runs the doubling chain for
each signature (the port's B1 and B2 run 3,414 and 3,140 products a
signature, ops/ladder.py `field_muls`) does far more than this count, so
its share reads low by that ratio.

Cost: one product of 255-bit elements in 32-bit limbs takes 216 IMAD
issue slots (ten 26/25-bit limbs, 100 partial products with their
reductions and carries, as counted from the SASS of one product against
two; chip_smoke.py's probe, `SLOTS_PER_MUL`). Peak: 132 SMs x 64 32-bit
multiply-adds an SM a clock (the CUDA C++ Programming Guide's throughput
table for compute capability 9.0) x 1,980 MHz, the H100 SXM part's boost
clock, at its 700 W limit: 1.6727e13 slots a second.

Bytes: each signature reads its 64 comb entries (6,144), R, s and h (96)
and a key index (4), and writes a 4-byte verdict: 6,248 bytes, against
3.35 TB/s: 1.9e-9 s, a third of the products' 5.8e-9 s.

The least time is the larger of the two. A kernel that follows another
schedule (fewer or more products) is measured against the same count;
this file is not changed to follow it.
"""

from __future__ import annotations

MIXED_ADD_T = 7                  # (y+x, y-x, 2dt) entry, T out
ADD_T = 9                        # two extended points, T out
DOUBLE_T = 8
AFFINE_ENTRY = 4 + 3             # x, y, xy, 2dt and a share of 1/Z
COMB_POSITIONS = 32              # signed 8-bit windows over 256 bits
COMB_ENTRIES = 128               # multiples 1..128 at each position

PRODUCT_PRODUCTS = 1 + (2 * COMB_POSITIONS - 2) * MIXED_ADD_T \
    + (MIXED_ADD_T - 1)                                           # 441
ENCODE_PRODUCTS = 2
MONTGOMERY_PRODUCTS = 3          # a signature's share of the shared inverse
INVERSE_PRODUCTS = 259 + 5 + 1   # 265
LAUNCH_PRODUCTS = INVERSE_PRODUCTS - MONTGOMERY_PRODUCTS          # 262
SQRT_PRODUCTS = 1 + 1 + 2 + 2 + 1 + 1 + (259 + 3) + 1 + 2 + 1     # 274
COMB_PRODUCTS = (COMB_POSITIONS - 1) * DOUBLE_T \
    + COMB_POSITIONS * (COMB_ENTRIES - 1) * ADD_T \
    + COMB_POSITIONS * COMB_ENTRIES * AFFINE_ENTRY + INVERSE_PRODUCTS  # 65761
SIG_PRODUCTS = PRODUCT_PRODUCTS + ENCODE_PRODUCTS + MONTGOMERY_PRODUCTS  # 446
KEY_PRODUCTS = SQRT_PRODUCTS + COMB_PRODUCTS                      # 66035

SLOTS_PER_PRODUCT = 216
SMS = 132
IMAD_PER_SM_CLOCK = 64
CLOCK_HZ = 1.98e9
PEAK_SLOTS_PER_S = SMS * IMAD_PER_SM_CLOCK * CLOCK_HZ
BYTES_PER_SIG = 2 * COMB_POSITIONS * 96 + 3 * 32 + 4 + 4
PEAK_BYTES_PER_S = 3.35e12


def products(sigs: int, launches: int, new_keys: int) -> int:
    return SIG_PRODUCTS * sigs + LAUNCH_PRODUCTS * launches \
        + KEY_PRODUCTS * new_keys


def least_seconds(sigs: int, launches: int, new_keys: int) -> float:
    """The larger of the products' and the bytes' bound, in seconds."""
    compute = products(sigs, launches, new_keys) * SLOTS_PER_PRODUCT \
        / PEAK_SLOTS_PER_S
    memory = sigs * BYTES_PER_SIG / PEAK_BYTES_PER_S
    return max(compute, memory)


def share(sigs: int, launches: int, new_keys: int, device_s: float):
    """Percent of the bound reached in `device_s` seconds of kernel time;
    None when there is no device time to divide by."""
    if not device_s or device_s <= 0 or sigs <= 0:
        return None
    return 100.0 * least_seconds(sigs, launches, new_keys) / device_s
