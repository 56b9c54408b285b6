"""Pure-Python FLAC codec (spec subset) — decode + fixture encode.

A copy of the JAX package's ``io/flac.py`` (numpy only), so that the port
decodes without importing that package; ``tests/test_torch_io_score.py``
holds the two decoders bitwise equal.

The reference's corpora are ASVspoof FLAC trees read through
``librosa.load`` / ``soundfile.info`` (reference/ASV_dl_func.py:63-75,
:195, :406). Neither libsndfile nor any FLAC CLI exists in this
environment, so the framework carries its own decoder: this module is the
portable fallback, ``native/flacdec.cpp`` is the threaded hot path used by
the batch loader.

Decoder coverage (the subset every ASVspoof file falls in, and then some):
streams with 8/12/16/20/24-bit samples, 1-8 channels, CONSTANT / VERBATIM /
FIXED(0-4) / LPC(1-32) subframes, RICE and RICE2 residual partitions with
escape codes, wasted bits, and all four stereo decorrelation modes
(independent, left/side, right/side, mid/side). Frame-header CRC-8 and
frame CRC-16 are verified.

The encoder exists so tests can round-trip fixtures without external tools:
it writes valid fixed-blocksize streams with a selectable subframe strategy
(constant / verbatim / fixed / lpc) and stereo mode, single Rice partition.
Round-trips are exact by construction (residuals are defined by the same
integer recurrences the decoder inverts), which the test suite asserts
sample-for-sample.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

_SYNC = 0x3FFE

# frame-header blocksize code -> samples (None = coded in header / reserved)
_BLOCKSIZE_TABLE = {
    1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
    8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096, 13: 8192, 14: 16384, 15: 32768,
}
_SAMPLE_RATE_TABLE = {
    1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000, 6: 22050, 7: 24000,
    8: 32000, 9: 44100, 10: 48000, 11: 96000,
}
_SAMPLE_SIZE_TABLE = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}

# fixed-predictor coefficients, order 1..4 (newest sample first)
_FIXED_COEFFS = {1: [1], 2: [2, -1], 3: [3, -3, 1], 4: [4, -6, 4, -1]}


def _crc_table(poly: int, width: int) -> list[int]:
    top = 1 << (width - 1)
    mask = (1 << width) - 1
    table = []
    for byte in range(256):
        crc = byte << (width - 8)
        for _ in range(8):
            crc = ((crc << 1) ^ poly) & mask if crc & top else (crc << 1) & mask
        table.append(crc)
    return table


_CRC8_TABLE = _crc_table(0x07, 8)
_CRC16_TABLE = _crc_table(0x8005, 16)


def _crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc = _CRC8_TABLE[crc ^ b]
    return crc


def _crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc = _CRC16_TABLE[(crc >> 8) ^ b] ^ ((crc << 8) & 0xFFFF)
    return crc


class FlacError(ValueError):
    """Malformed or out-of-subset FLAC stream."""


@dataclass(frozen=True)
class FlacStreamInfo:
    min_block_size: int
    max_block_size: int
    sample_rate: int
    channels: int
    bits_per_sample: int
    total_samples: int  # 0 = unknown


class _BitReader:
    """MSB-first bit reader over a bytes buffer."""

    __slots__ = ("data", "byte", "acc", "n")

    def __init__(self, data: bytes, byte_offset: int = 0):
        self.data = data
        self.byte = byte_offset
        self.acc = 0
        self.n = 0

    def read(self, bits: int) -> int:
        try:
            while self.n < bits:
                self.acc = (self.acc << 8) | self.data[self.byte]
                self.byte += 1
                self.n += 8
        except IndexError:
            raise FlacError("truncated stream") from None
        self.n -= bits
        val = self.acc >> self.n
        self.acc &= (1 << self.n) - 1
        return val

    def read_signed(self, bits: int) -> int:
        v = self.read(bits)
        return v - (1 << bits) if v >> (bits - 1) else v

    def read_unary(self) -> int:
        """Number of 0 bits before the next 1 bit (the 1 is consumed)."""
        q = 0
        while True:
            if self.n == 0:
                if self.byte >= len(self.data):
                    raise FlacError("truncated stream")
                self.acc = self.data[self.byte]
                self.byte += 1
                self.n = 8
            if self.acc == 0:
                q += self.n
                self.n = 0
                continue
            bl = self.acc.bit_length()
            q += self.n - bl
            self.n = bl - 1
            self.acc &= (1 << self.n) - 1
            return q

    def align(self) -> None:
        self.acc = 0
        self.n = 0

    def bit_pos(self) -> int:
        return self.byte * 8 - self.n


def _read_utf8_number(br: _BitReader) -> int:
    """FLAC's UTF-8-style coded frame/sample number (up to 7 bytes)."""
    b0 = br.read(8)
    if b0 < 0x80:
        return b0
    n_extra = 0
    mask = 0x40
    while b0 & mask:
        n_extra += 1
        mask >>= 1
    if n_extra == 0 or n_extra > 6:
        raise FlacError("invalid UTF-8-coded number")
    val = b0 & (mask - 1)
    for _ in range(n_extra):
        b = br.read(8)
        if (b & 0xC0) != 0x80:
            raise FlacError("invalid UTF-8 continuation byte")
        val = (val << 6) | (b & 0x3F)
    return val


def _parse_stream_header(data: bytes) -> tuple[FlacStreamInfo, int]:
    """Parse 'fLaC' + metadata blocks; return (streaminfo, first frame offset)."""
    if data[:4] != b"fLaC":
        raise FlacError("not a FLAC stream (missing fLaC magic)")
    pos = 4
    info: FlacStreamInfo | None = None
    while True:
        if pos + 4 > len(data):
            raise FlacError("truncated metadata block header")
        header = data[pos]
        last = bool(header & 0x80)
        btype = header & 0x7F
        length = int.from_bytes(data[pos + 1 : pos + 4], "big")
        pos += 4
        if btype == 0:  # STREAMINFO
            if length < 34:
                raise FlacError("short STREAMINFO")
            br = _BitReader(data[pos : pos + 34])
            min_bs = br.read(16)
            max_bs = br.read(16)
            br.read(24)  # min frame size
            br.read(24)  # max frame size
            sr = br.read(20)
            ch = br.read(3) + 1
            bps = br.read(5) + 1
            total = br.read(36)
            info = FlacStreamInfo(min_bs, max_bs, sr, ch, bps, total)
        pos += length
        if last:
            break
    if info is None:
        raise FlacError("no STREAMINFO block")
    return info, pos


def _decode_residual(br: _BitReader, block_size: int, order: int) -> np.ndarray:
    """Rice-coded residual -> int64 array of block_size - order values."""
    method = br.read(2)
    if method > 1:
        raise FlacError(f"reserved residual coding method {method}")
    param_bits = 4 if method == 0 else 5
    escape = (1 << param_bits) - 1
    part_order = br.read(4)
    n_parts = 1 << part_order
    if block_size % n_parts or (block_size >> part_order) <= order:
        raise FlacError("invalid residual partition order")
    out = np.empty(block_size - order, dtype=np.int64)
    idx = 0
    for p in range(n_parts):
        count = (block_size >> part_order) - (order if p == 0 else 0)
        param = br.read(param_bits)
        if param == escape:
            raw_bits = br.read(5)
            if raw_bits == 0:
                out[idx : idx + count] = 0
            else:
                for i in range(count):
                    out[idx + i] = br.read_signed(raw_bits)
        else:
            read_unary = br.read_unary
            read = br.read
            for i in range(count):
                q = read_unary()
                val = (q << param) | read(param) if param else q
                out[idx + i] = (val >> 1) ^ -(val & 1)
        idx += count
    return out


def _restore_fixed(warmup: np.ndarray, residual: np.ndarray, order: int) -> np.ndarray:
    """Invert the order-N finite-difference predictor via N cumulative sums."""
    if order == 0:
        return residual.copy()
    # k-th differences of the warmup seed the k-fold integration chain
    data = residual
    for k in range(order, 0, -1):
        seed = np.diff(warmup, k - 1)[-1:]  # Δ^(k-1) warmup, last value
        data = np.cumsum(np.concatenate([seed, data]))[1:]
    return np.concatenate([warmup, data])


def _restore_lpc(
    warmup: np.ndarray, residual: np.ndarray, coeffs: list[int], shift: int
) -> np.ndarray:
    order = len(coeffs)
    n = order + len(residual)
    out = [0] * n
    out[:order] = [int(v) for v in warmup]
    res = [int(v) for v in residual]
    for i in range(order, n):
        acc = 0
        for j, c in enumerate(coeffs):  # coeffs[0] multiplies newest sample
            acc += c * out[i - 1 - j]
        out[i] = res[i - order] + (acc >> shift)
    return np.asarray(out, dtype=np.int64)


def _decode_subframe(br: _BitReader, block_size: int, bps: int) -> np.ndarray:
    if br.read(1):
        raise FlacError("subframe padding bit set")
    stype = br.read(6)
    wasted = 0
    if br.read(1):
        wasted = br.read_unary() + 1
    eff_bps = bps - wasted
    if stype == 0:  # CONSTANT
        out = np.full(block_size, br.read_signed(eff_bps), dtype=np.int64)
    elif stype == 1:  # VERBATIM
        read_signed = br.read_signed
        out = np.fromiter(
            (read_signed(eff_bps) for _ in range(block_size)), np.int64, block_size
        )
    elif 8 <= stype <= 12:  # FIXED, order = stype - 8
        order = stype - 8
        warmup = np.fromiter(
            (br.read_signed(eff_bps) for _ in range(order)), np.int64, order
        )
        residual = _decode_residual(br, block_size, order)
        out = _restore_fixed(warmup, residual, order)
    elif stype >= 32:  # LPC, order = (stype & 31) + 1
        order = (stype & 0x1F) + 1
        warmup = np.fromiter(
            (br.read_signed(eff_bps) for _ in range(order)), np.int64, order
        )
        precision = br.read(4) + 1
        if precision == 16:
            raise FlacError("invalid LPC coefficient precision escape")
        shift = br.read_signed(5)
        if shift < 0:
            raise FlacError("negative LPC shift")
        coeffs = [br.read_signed(precision) for _ in range(order)]
        residual = _decode_residual(br, block_size, order)
        out = _restore_lpc(warmup, residual, coeffs, shift)
    else:
        raise FlacError(f"reserved subframe type {stype}")
    if wasted:
        out <<= wasted
    return out


def _decode_frame(
    data: bytes, pos: int, info: FlacStreamInfo
) -> tuple[np.ndarray, int]:
    """Decode one frame at byte offset pos -> ((block, channels) int64, next pos)."""
    br = _BitReader(data, pos)
    if br.read(14) != _SYNC:
        raise FlacError(f"lost frame sync at byte {pos}")
    if br.read(1):
        raise FlacError("reserved bit set in frame header")
    br.read(1)  # blocking strategy (both handled identically here)
    bs_code = br.read(4)
    sr_code = br.read(4)
    chan_code = br.read(4)
    size_code = br.read(3)
    if br.read(1):
        raise FlacError("reserved bit set in frame header")
    _read_utf8_number(br)
    if bs_code == 0:
        raise FlacError("reserved blocksize code 0")
    elif bs_code == 6:
        block_size = br.read(8) + 1
    elif bs_code == 7:
        block_size = br.read(16) + 1
    else:
        block_size = _BLOCKSIZE_TABLE[bs_code]
    if sr_code == 0:
        pass
    elif sr_code == 12:
        br.read(8)
    elif sr_code in (13, 14):
        br.read(16)
    elif sr_code == 15:
        raise FlacError("invalid sample-rate code 15")
    bps = info.bits_per_sample if size_code == 0 else _SAMPLE_SIZE_TABLE.get(size_code)
    if bps is None:
        raise FlacError(f"reserved sample-size code {size_code}")
    header_end = br.byte  # header CRC-8 covers [pos, header_end)
    expected_crc8 = br.read(8)
    if _crc8(data[pos:header_end]) != expected_crc8:
        raise FlacError(f"frame header CRC-8 mismatch at byte {pos}")

    if chan_code <= 7:
        channels = chan_code + 1
        chan_bps = [bps] * channels
    elif chan_code == 8:  # left/side
        channels, chan_bps = 2, [bps, bps + 1]
    elif chan_code == 9:  # right/side
        channels, chan_bps = 2, [bps + 1, bps]
    elif chan_code == 10:  # mid/side
        channels, chan_bps = 2, [bps, bps + 1]
    else:
        raise FlacError(f"reserved channel assignment {chan_code}")

    subframes = [_decode_subframe(br, block_size, chan_bps[c]) for c in range(channels)]
    br.align()
    frame_end = br.byte
    expected_crc16 = br.read(16)
    if _crc16(data[pos:frame_end]) != expected_crc16:
        raise FlacError(f"frame CRC-16 mismatch at byte {pos}")

    if chan_code == 8:
        left, side = subframes
        subframes = [left, left - side]
    elif chan_code == 9:
        side, right = subframes
        subframes = [right + side, right]
    elif chan_code == 10:
        mid, side = subframes
        lr_sum = (mid << 1) | (side & 1)
        subframes = [(lr_sum + side) >> 1, (lr_sum - side) >> 1]
    return np.stack(subframes, axis=1), br.byte


def flac_stream_info(path: str) -> FlacStreamInfo:
    """STREAMINFO probe without decoding (the ``soundfile.info`` role)."""
    with open(path, "rb") as f:
        head = f.read(64 * 1024)  # metadata usually fits; frames not needed
        try:
            return _parse_stream_header(head)[0]
        except FlacError:
            # metadata blocks past 64 KB (cover art / large padding): the
            # header walk needs every block present — retry on the full file
            head += f.read()
    return _parse_stream_header(head)[0]


def decode_flac(path: str) -> tuple[np.ndarray, FlacStreamInfo]:
    """Full decode -> ((n_samples, channels) int32, streaminfo)."""
    with open(path, "rb") as f:
        data = f.read()
    info, pos = _parse_stream_header(data)
    blocks = []
    total = 0
    while pos < len(data) and (info.total_samples == 0 or total < info.total_samples):
        try:
            block, pos = _decode_frame(data, pos, info)
        except FlacError:
            if info.total_samples == 0 and blocks:
                # unknown-length stream (streaming encoder): trailing
                # non-frame bytes after the last good frame are tolerated —
                # every declared frame was already recovered
                break
            raise
        blocks.append(block)
        total += block.shape[0]
    if info.total_samples and total < info.total_samples:
        # the stream ended cleanly at a frame boundary but short of what
        # STREAMINFO declared — a truncated file, not a short stream
        raise FlacError(
            f"truncated stream: {total} of {info.total_samples} declared samples"
        )
    if not blocks:
        return np.zeros((0, info.channels), dtype=np.int32), info
    out = np.concatenate(blocks, axis=0)
    if info.total_samples and out.shape[0] > info.total_samples:
        out = out[: info.total_samples]
    return out.astype(np.int32), info


def read_flac(path: str) -> tuple[np.ndarray, int]:
    """float32 mono waveform + sample rate (librosa.load scaling, no resample)."""
    samples, info = decode_flac(path)
    y = samples.astype(np.float32) / float(1 << (info.bits_per_sample - 1))
    if y.shape[1] > 1:
        y = y.mean(axis=1)
    else:
        y = y[:, 0]
    return np.ascontiguousarray(y), info.sample_rate


# --------------------------------------------------------------------------
# Encoder (fixtures + round-trip validation; fixed blocksize, 1 partition)
# --------------------------------------------------------------------------


class _BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.n = 0

    def write(self, value: int, bits: int) -> None:
        self.acc = (self.acc << bits) | (value & ((1 << bits) - 1))
        self.n += bits
        while self.n >= 8:
            self.n -= 8
            self.buf.append((self.acc >> self.n) & 0xFF)
        self.acc &= (1 << self.n) - 1

    def write_unary(self, q: int) -> None:
        while q >= 32:
            self.write(0, 32)
            q -= 32
        self.write(1, q + 1)

    def align(self) -> None:
        if self.n:
            self.write(0, 8 - self.n)

    def bytes(self) -> bytes:
        assert self.n == 0
        return bytes(self.buf)


def _utf8_code(bw: _BitWriter, val: int) -> None:
    if val < 0x80:
        bw.write(val, 8)
        return
    payload = []
    n_extra = 1
    while val >> (6 * n_extra) >= (1 << (6 - n_extra)) and n_extra < 6:
        n_extra += 1
    for i in range(n_extra):
        payload.append(0x80 | ((val >> (6 * (n_extra - 1 - i))) & 0x3F))
    lead = (0xFF << (7 - n_extra)) & 0xFF | (val >> (6 * n_extra))
    bw.write(lead, 8)
    for b in payload:
        bw.write(b, 8)


def _rice_param_for(zigzag_sum: int, count: int, max_param: int) -> int:
    param = 0
    while count << (param + 1) < zigzag_sum and param < max_param:
        param += 1
    return param


def _write_residual(
    bw: _BitWriter, residual: np.ndarray, pred_order: int, partition_order: int = 0
) -> None:
    """RICE residual partitions (per-partition escape to raw bits when needed)."""
    block_size = len(residual) + pred_order
    n_parts = 1 << partition_order
    if block_size % n_parts or (block_size >> partition_order) <= pred_order:
        raise ValueError("invalid partition order for this block")
    bw.write(0, 2)  # method = RICE (4-bit params)
    bw.write(partition_order, 4)
    idx = 0
    for p in range(n_parts):
        count = (block_size >> partition_order) - (pred_order if p == 0 else 0)
        part = residual[idx : idx + count]
        idx += count
        zig = np.abs(part) * 2 - (part < 0)
        zigzag_sum = int(zig.sum())
        param = _rice_param_for(zigzag_sum, max(count, 1), 14)
        # escape if unary quotients would blow up (worst-case residual)
        max_q = int(zig.max(initial=0)) >> param
        if max_q > 1024:
            raw_bits = max(int(np.abs(part).max(initial=0)).bit_length() + 1, 1)
            if raw_bits > 31:
                # the escape header is a 5-bit field; silently masking it
                # would write an undecodable stream. Residuals this wide
                # mean a degenerate predictor — refuse loudly.
                raise FlacError(
                    f"residual needs {raw_bits}-bit raw escape (> 31) — "
                    "predictor degenerate for this input; use subframe_mode="
                    "'verbatim' or 'fixed'"
                )
            bw.write(15, 4)
            bw.write(raw_bits, 5)
            for v in part:
                bw.write(int(v), raw_bits)
            continue
        bw.write(param, 4)
        for z in zig:
            z = int(z)
            bw.write_unary(z >> param)
            if param:
                bw.write(z, param)


def _best_fixed_order(x: np.ndarray) -> tuple[int, np.ndarray]:
    best_order, best_res, best_cost = 0, x[0:].copy(), float(np.abs(x).sum())
    d = x
    for order in range(1, 5):
        if len(x) <= order:
            break
        d = np.diff(d)
        cost = float(np.abs(d).sum())
        if cost < best_cost:
            best_order, best_res, best_cost = order, d.copy(), cost
    return best_order, best_res


def _lpc_coefficients(x: np.ndarray, order: int, precision: int) -> tuple[list[int], int]:
    """Levinson-Durbin + quantization (compression-only; exactness is by design)."""
    xf = x.astype(np.float64)
    n = len(xf)
    autoc = np.array([np.dot(xf[: n - k], xf[k:]) for k in range(order + 1)])
    if autoc[0] == 0:
        return [0] * order, 0
    err = autoc[0]
    a = np.zeros(order)
    for i in range(order):
        acc = autoc[i + 1] - np.dot(a[:i], autoc[i:0:-1][:i])
        k = acc / err if err > 0 else 0.0
        a[:i], a[i] = a[:i] - k * a[i::-1][1 : i + 1], k
        err *= max(1.0 - k * k, 1e-12)
    cmax = np.abs(a).max()
    if cmax == 0:
        return [0] * order, 0
    shift = min(max(precision - 1 - int(np.floor(np.log2(cmax))) - 1, 0), 15)
    q = np.clip(
        np.round(a * (1 << shift)), -(1 << (precision - 1)), (1 << (precision - 1)) - 1
    ).astype(np.int64)
    return [int(v) for v in q], shift


def _write_subframe(
    bw: _BitWriter, x: np.ndarray, bps: int, mode: str, partition_order: int = 0
) -> None:
    x = np.asarray(x, dtype=np.int64)

    def _po_for(order: int) -> int:
        po = partition_order
        while po and (len(x) % (1 << po) or (len(x) >> po) <= order):
            po -= 1
        return po

    if mode == "auto" and np.all(x == x[0]):
        mode = "constant"
    if mode == "constant":
        if not np.all(x == x[0]):
            raise ValueError("constant subframe on non-constant block")
        bw.write(0, 1 + 6 + 1)  # pad, type 0, no wasted bits
        bw.write(int(x[0]), bps)
    elif mode == "verbatim":
        bw.write(0, 1)
        bw.write(1, 6)
        bw.write(0, 1)
        for v in x:
            bw.write(int(v), bps)
    elif mode in ("auto", "fixed"):
        order, residual = _best_fixed_order(x)
        bw.write(0, 1)
        bw.write(8 + order, 6)
        bw.write(0, 1)
        for v in x[:order]:
            bw.write(int(v), bps)
        _write_residual(bw, residual, order, _po_for(order))
    elif mode == "lpc":
        precision = 12
        order = min(8, len(x) - 1)
        if order < 1:
            return _write_subframe(bw, x, bps, "verbatim")
        coeffs, shift = _lpc_coefficients(x, order, precision)
        pred = np.zeros(len(x) - order, dtype=np.int64)
        for j, c in enumerate(coeffs):
            pred += c * x[order - 1 - j : len(x) - 1 - j]
        residual = x[order:] - (pred >> shift)
        bw.write(0, 1)
        bw.write(32 | (order - 1), 6)
        bw.write(0, 1)
        for v in x[:order]:
            bw.write(int(v), bps)
        bw.write(precision - 1, 4)
        bw.write(shift, 5)
        for c in coeffs:
            bw.write(c, precision)
        _write_residual(bw, residual, order, _po_for(order))
    else:
        raise ValueError(f"unknown subframe mode {mode!r}")


_SR_CODE = {v: k for k, v in _SAMPLE_RATE_TABLE.items()}
_BPS_CODE = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6, 32: 7}


def write_flac(
    path: str,
    samples: np.ndarray,
    sr: int,
    *,
    bits_per_sample: int = 16,
    block_size: int = 4096,
    subframe_mode: str = "auto",
    stereo_mode: str = "independent",
    rice_partition_order: int = 0,
) -> None:
    """Write a fixed-blocksize FLAC stream (test fixtures / dataset export).

    ``samples``: int array, shape (n,) or (n, channels), values within
    ``bits_per_sample`` signed range. ``subframe_mode``: auto | constant |
    verbatim | fixed | lpc. ``stereo_mode`` (2-channel only): independent |
    left_side | right_side | mid_side. ``rice_partition_order`` is lowered
    per frame when the block does not divide into 2^order partitions.
    """
    x = np.asarray(samples)
    if x.ndim == 1:
        x = x[:, None]
    n, channels = x.shape
    if channels > 8:
        raise ValueError("FLAC supports at most 8 channels")
    bps = bits_per_sample
    lo, hi = -(1 << (bps - 1)), (1 << (bps - 1)) - 1
    if x.min(initial=0) < lo or x.max(initial=0) > hi:
        raise ValueError(f"samples exceed {bps}-bit signed range")
    x = x.astype(np.int64)
    if stereo_mode != "independent" and channels != 2:
        raise ValueError("stereo decorrelation requires exactly 2 channels")

    out = bytearray(b"fLaC")
    si = _BitWriter()
    si.write(block_size, 16)
    si.write(block_size, 16)
    si.write(0, 24)
    si.write(0, 24)
    si.write(sr, 20)
    si.write(channels - 1, 3)
    si.write(bps - 1, 5)
    si.write(n, 36)
    streaminfo = si.bytes() + b"\x00" * 16  # MD5 unknown
    out += bytes([0x80]) + len(streaminfo).to_bytes(3, "big") + streaminfo

    sr_code = _SR_CODE.get(sr)
    if sr_code is None:
        sr_code = 13 if sr < (1 << 16) else 0  # 16-bit Hz field, else streaminfo
    bps_code = _BPS_CODE.get(bps, 0)

    for frame_idx, start in enumerate(range(0, max(n, 1), block_size)):
        block = x[start : start + block_size]
        bs = block.shape[0]
        if bs == 0:
            break
        if stereo_mode == "independent":
            chan_code = channels - 1
            chans = [(block[:, c], bps) for c in range(channels)]
        elif stereo_mode == "left_side":
            chan_code = 8
            chans = [(block[:, 0], bps), (block[:, 0] - block[:, 1], bps + 1)]
        elif stereo_mode == "right_side":
            chan_code = 9
            chans = [(block[:, 0] - block[:, 1], bps + 1), (block[:, 1], bps)]
        elif stereo_mode == "mid_side":
            chan_code = 10
            chans = [
                ((block[:, 0] + block[:, 1]) >> 1, bps),
                (block[:, 0] - block[:, 1], bps + 1),
            ]
        else:
            raise ValueError(f"unknown stereo mode {stereo_mode!r}")

        bw = _BitWriter()
        bw.write(_SYNC, 14)
        bw.write(0, 1)  # reserved
        bw.write(0, 1)  # fixed blocksize strategy
        bw.write(7, 4)  # blocksize: 16-bit field (uniform; last frame may be short)
        bw.write(sr_code, 4)
        bw.write(chan_code, 4)
        bw.write(bps_code, 3)
        bw.write(0, 1)  # reserved
        _utf8_code(bw, frame_idx)
        bw.write(bs - 1, 16)
        if sr_code == 12:
            bw.write(sr // 1000, 8)
        elif sr_code == 13:
            bw.write(sr, 16)
        elif sr_code == 14:
            bw.write(sr // 10, 16)
        bw.align()
        header = bw.bytes()
        header += bytes([_crc8(header)])

        body = _BitWriter()
        for chan_x, chan_bps in chans:
            _write_subframe(body, chan_x, chan_bps, subframe_mode, rice_partition_order)
        body.align()
        frame = header + body.bytes()
        frame += _crc16(frame).to_bytes(2, "big")
        out += frame

    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(out)
    os.replace(tmp, path)
