"""The port's consensus WAL (tendermint_tpu_torch.storage.wal) against the
JAX package's, on the CPU.

Every WAL case of tests/test_storage.py runs in both packages on the same
inputs: the files they leave must be equal byte for byte, the messages
read back equal, and every error of the same class with the same
message. Frames and CRCs are compared directly, and decode_frames is
held on truncated and corrupt tails cut at every byte of a frame.
"""

import os
import struct

import pytest

from tendermint_tpu.storage import wal as jwal
from tendermint_tpu_torch.storage import wal as twal

PKGS = {"jax": jwal, "port": twal}


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _types(w):
    return [m.msg.get("type") for m in w.all_messages()]


def _both(case, tmp_path):
    out = {}
    for name, W in PKGS.items():
        d = tmp_path / name
        d.mkdir()
        out[name] = case(W, str(d))
    assert out["port"] == out["jax"]
    return out["port"]


def case_roundtrip_and_endheight_search(W, d):
    path = os.path.join(d, "wal")
    wal = W.WAL(path)
    wal.save({"type": "vote", "h": 1}, time_ns=10)
    wal.save_end_height(1)
    wal.save({"type": "proposal", "h": 2}, time_ns=20)
    wal.save({"type": "vote", "h": 2}, time_ns=21)
    wal.close()
    wal2 = W.WAL(path)
    tail = wal2.messages_after_end_height(1)
    assert [m.msg["type"] for m in tail] == ["proposal", "vote"]
    assert wal2.messages_after_end_height(7) is None
    assert len(wal2.all_messages()) == 5
    wal2.close()
    return _read(path), [m.to_obj() for m in tail]


def case_fresh_wal_has_endheight_zero(W, d):
    path = os.path.join(d, "wal")
    wal = W.WAL(path)
    assert wal.messages_after_end_height(0) == []
    wal.save({"type": "vote", "h": 1})
    wal.close()
    wal2 = W.WAL(path)
    assert _types(wal2) == ["endheight", "vote"]
    wal2.close()
    return _read(path)


def case_truncated_tail_is_tolerated(W, d):
    path = os.path.join(d, "wal")
    wal = W.WAL(path)
    wal.save({"type": "a"})
    wal.save({"type": "b"})
    wal.close()
    data = _read(path)
    with open(path, "wb") as f:
        f.write(data[:-3])
    wal2 = W.WAL(path)
    assert _types(wal2) == ["endheight", "a"]
    wal2.close()
    return _read(path)


def case_appends_after_torn_tail_stay_readable(W, d):
    path = os.path.join(d, "wal")
    wal = W.WAL(path)
    wal.save({"type": "a"})
    wal.save({"type": "b"})
    wal.close()
    data = _read(path)
    with open(path, "wb") as f:
        f.write(data[:-3])
    wal2 = W.WAL(path)
    wal2.save({"type": "c"})
    wal2.close()
    wal3 = W.WAL(path)
    assert _types(wal3) == ["endheight", "a", "c"]
    wal3.close()
    return _read(path)


def case_torn_initial_marker_rewritten(W, d):
    path = os.path.join(d, "wal")
    W.WAL(path).close()
    data = _read(path)
    with open(path, "wb") as f:
        f.write(data[:5])
    wal = W.WAL(path)
    assert wal.messages_after_end_height(0) == []
    wal.close()
    return _read(path)


def case_zero_filled_tail_is_trimmed(W, d):
    path = os.path.join(d, "wal")
    wal = W.WAL(path)
    wal.save({"type": "a"})
    wal.save({"type": "b"})
    wal.close()
    good = _read(path)
    frame_c = W.encode_frame(W.WALMessage(0, {"type": "c", "pad": "y" * 48}))
    files = []
    for tail in (b"\x00" * 24, b"\x00" * 13, frame_c[:12],
                 frame_c[:12] + b"\x00" * 16):
        with open(path, "wb") as f:
            f.write(good + tail)
        wal2 = W.WAL(path)
        assert _types(wal2) == ["endheight", "a", "b"]
        wal2.save({"type": "c"})
        wal2.close()
        wal3 = W.WAL(path)
        assert _types(wal3) == ["endheight", "a", "b", "c"]
        wal3.close()
        files.append(_read(path))
    return files


def case_large_zero_tail_trims(W, d):
    path = os.path.join(d, "wal")
    wal = W.WAL(path)
    wal.save({"type": "a"})
    wal.close()
    with open(path, "ab") as f:
        f.write(b"\x00" * (8 << 20))
    wal2 = W.WAL(path)
    assert _types(wal2) == ["endheight", "a"]
    wal2.close()
    return _read(path)


def case_midfile_length_corruption_not_trimmed(W, d):
    path = os.path.join(d, "wal")
    wal = W.WAL(path)
    wal.save({"type": "a"})
    wal.save({"type": "b", "pad": "x" * 40})
    wal.save({"type": "c"})
    wal.close()
    data = bytearray(_read(path))
    off = 0
    for _ in range(2):
        _, ln = struct.unpack_from(">II", data, off)
        off += 8 + ln
    crc_b, ln_b = struct.unpack_from(">II", data, off)
    struct.pack_into(">II", data, off, crc_b, ln_b + 64)
    with open(path, "wb") as f:
        f.write(data)
    errors = []
    wal2 = W.WAL(path)
    assert _read(path) == bytes(data), "corrupt WAL was mutated"
    with pytest.raises(W.WALCorruptionError, match="resume after") as e:
        wal2.all_messages()
    errors.append(str(e.value))
    wal2.close()
    frame_d = W.encode_frame(W.WALMessage(0, {"type": "d"}))
    data_torn = bytes(data) + frame_d[:11]
    with open(path, "wb") as f:
        f.write(data_torn)
    wal3 = W.WAL(path)
    assert _read(path) == data_torn
    with pytest.raises(W.WALCorruptionError, match="resume after") as e:
        wal3.all_messages()
    errors.append(str(e.value))
    wal3.close()
    return errors


def case_rotated_empty_head_gets_no_spurious_marker(W, d):
    path = os.path.join(d, "wal")
    wal = W.WAL(path, rotate_bytes=1)
    wal.save_end_height(3)
    wal.close()
    assert os.path.getsize(path) == 0 and os.path.exists(path + ".1")
    wal2 = W.WAL(path, rotate_bytes=1)
    msgs = [m.msg for m in wal2.all_messages()]
    assert msgs[-1] == {"type": "endheight", "height": 3}
    assert wal2.messages_after_end_height(3) == []
    wal2.close()
    return msgs, _read(path + ".1")


def case_rotation_spans_endheight_search(W, d):
    path = os.path.join(d, "wal")
    wal = W.WAL(path, rotate_bytes=256)
    for h in range(1, 8):
        wal.save({"type": "vote", "h": h, "pad": "x" * 64})
        wal.save_end_height(h)
    wal.close()
    assert os.path.exists(path + ".1")
    wal2 = W.WAL(path, rotate_bytes=256)
    tail = wal2.messages_after_end_height(3)
    assert tail[0].msg == {"type": "vote", "h": 4, "pad": "x" * 64}
    assert len(wal2.messages_after_end_height(7)) == 0
    wal2.close()
    files = sorted(os.listdir(d))
    return files, [_read(os.path.join(d, f)) for f in files]


def case_light_mode_skips_peer_messages(W, d):
    path = os.path.join(d, "wal")
    wal = W.WAL(path, light=True)
    wal.save({"type": "vote", "peer": "p1"})
    wal.save({"type": "vote"})
    wal.close()
    return _read(path)


def case_readonly_handle_leaves_the_file(W, d):
    path = os.path.join(d, "wal")
    wal = W.WAL(path)
    wal.save({"type": "a"})
    wal.close()
    data = _read(path)
    with open(path, "wb") as f:
        f.write(data[:-2])
    ro = W.WAL(path, readonly=True)
    ro.save({"type": "b"})
    msgs = _types(ro)
    ro.close()
    assert _read(path) == data[:-2]
    return msgs


WAL_CASES = [
    case_roundtrip_and_endheight_search,
    case_fresh_wal_has_endheight_zero,
    case_truncated_tail_is_tolerated,
    case_appends_after_torn_tail_stay_readable,
    case_torn_initial_marker_rewritten,
    case_zero_filled_tail_is_trimmed,
    case_large_zero_tail_trims,
    case_midfile_length_corruption_not_trimmed,
    case_rotated_empty_head_gets_no_spurious_marker,
    case_rotation_spans_endheight_search,
    case_light_mode_skips_peer_messages,
    case_readonly_handle_leaves_the_file,
]


@pytest.mark.parametrize("case", WAL_CASES, ids=lambda f: f.__name__[5:])
def test_wal_case_matches_jax(case, tmp_path):
    _both(case, tmp_path)


MESSAGES = [
    {"type": "vote", "vote": {"height": 3, "round": 0, "sig": "ab" * 32}},
    {"type": "endheight", "height": 2},
    {"type": "round_state", "height": 3, "round": 1, "step": 4},
    {"type": "timeout", "ti": {"duration_ns": 0, "height": 3, "round": 0,
                               "step": 1}},
    {"type": "block_part", "height": 9, "round": 2,
     "part": {"index": 0, "bytes": "00" * 300, "proof": ["ff" * 32]}},
]


@pytest.mark.parametrize("i", range(len(MESSAGES)))
def test_frames_and_crcs_match_jax(i):
    m = MESSAGES[i]
    fj = jwal.encode_frame(jwal.WALMessage(123456789 + i, m))
    ft = twal.encode_frame(twal.WALMessage(123456789 + i, m))
    assert ft == fj
    crc, ln = struct.unpack(">II", ft[:8])
    assert ln == len(ft) - 8
    assert [w.to_obj() for w in twal.decode_frames(ft)] == \
        [w.to_obj() for w in jwal.decode_frames(fj)]


def _outcome(W, data, tolerate):
    try:
        return ("ok", [m.to_obj() for m in W.decode_frames(data, tolerate)])
    except W.WALCorruptionError as e:
        return ("error", str(e))


def test_decode_frames_on_every_cut_and_flip_matches_jax():
    """Two frames then a third cut at every byte (torn tails), and a byte
    flipped at every offset of the stream (corruption): the same
    messages or the same error, with the tail tolerated and not."""
    frames = b"".join(twal.encode_frame(twal.WALMessage(i, m))
                      for i, m in enumerate(MESSAGES[:3]))
    seen = set()
    for cut in range(len(frames) + 1):
        for tolerate in (True, False):
            got = _outcome(twal, frames[:cut], tolerate)
            assert got == _outcome(jwal, frames[:cut], tolerate), cut
            seen.add(got[0])
    for off in range(len(frames)):
        bad = bytearray(frames)
        bad[off] ^= 0x41
        got = _outcome(twal, bytes(bad), True)
        assert got == _outcome(jwal, bytes(bad), True), off
    assert seen == {"ok", "error"}


def test_oversized_frame_refused_at_write_like_jax():
    m = {"type": "x", "pad": "y" * (2 << 20)}
    errs = []
    for W in (jwal, twal):
        with pytest.raises(ValueError) as e:
            W.encode_frame(W.WALMessage(0, m))
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_nil_wal():
    for W in (jwal, twal):
        w = W.NilWAL()
        w.save({"type": "x"})
        w.save_end_height(1)
        w.flush()
        w.close()
        assert w.all_messages() == []
        assert w.messages_after_end_height(1) is None
