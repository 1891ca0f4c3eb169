"""Pure-Python FLAC decoder (subset: what real speech corpora use).

The port's copy of whisperlive_tpu/audio/flac.py (it imports nothing of the
JAX package): load_audio decodes `.flac` files here, with no native audio
dependency. Supports the FLAC subset emitted by the reference `flac`
encoder: 16/24-bit, mono/stereo, constant/verbatim/fixed/LPC subframes,
4-bit and 5-bit Rice residual coding, all channel decorrelation modes.
"""

from __future__ import annotations

import struct

import numpy as np


class _BitReader:
    __slots__ = ("data", "pos", "bitpos")

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos  # byte position
        self.bitpos = 0  # bit within current byte (0..7, MSB first)

    def read_bits(self, n: int) -> int:
        out = 0
        data = self.data
        pos, bitpos = self.pos, self.bitpos
        while n > 0:
            avail = 8 - bitpos
            take = min(n, avail)
            byte = data[pos]
            shift = avail - take
            out = (out << take) | ((byte >> shift) & ((1 << take) - 1))
            bitpos += take
            if bitpos == 8:
                pos += 1
                bitpos = 0
            n -= take
        self.pos, self.bitpos = pos, bitpos
        return out

    def read_signed(self, n: int) -> int:
        v = self.read_bits(n)
        if v >= 1 << (n - 1):
            v -= 1 << n
        return v

    def read_unary(self) -> int:
        """Count zero bits until a one bit."""
        count = 0
        data = self.data
        while True:
            byte = data[self.pos]
            rem = 8 - self.bitpos
            chunk = byte & ((1 << rem) - 1)
            if chunk == 0:
                count += rem
                self.pos += 1
                self.bitpos = 0
                continue
            lead = rem - chunk.bit_length()
            count += lead
            self.bitpos += lead + 1
            if self.bitpos == 8:
                self.pos += 1
                self.bitpos = 0
            return count

    def align(self) -> None:
        if self.bitpos:
            self.pos += 1
            self.bitpos = 0


def _read_utf8_number(br: _BitReader) -> int:
    b0 = br.read_bits(8)
    if b0 < 0x80:
        return b0
    n = 0
    mask = 0x80
    while b0 & mask:
        n += 1
        mask >>= 1
    val = b0 & (mask - 1)
    for _ in range(n - 1):
        val = (val << 6) | (br.read_bits(8) & 0x3F)
    return val


_BLOCK_SIZES = {
    1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
    8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096,
    13: 8192, 14: 16384, 15: 32768,
}
_SAMPLE_RATES = {
    1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000, 6: 22050,
    7: 24000, 8: 32000, 9: 44100, 10: 48000, 11: 96000,
}
_SAMPLE_SIZES = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}

_FIXED_COEFFS = {
    0: [],
    1: [1],
    2: [2, -1],
    3: [3, -3, 1],
    4: [4, -6, 4, -1],
}


def _decode_residual(br: _BitReader, block_size: int, predictor_order: int) -> np.ndarray:
    method = br.read_bits(2)
    if method > 1:
        raise ValueError(f"unsupported residual method {method}")
    param_bits = 4 if method == 0 else 5
    escape = (1 << param_bits) - 1
    partition_order = br.read_bits(4)
    n_partitions = 1 << partition_order
    residual = np.empty(block_size - predictor_order, np.int64)
    idx = 0
    for p in range(n_partitions):
        count = block_size >> partition_order
        if p == 0:
            count -= predictor_order
        param = br.read_bits(param_bits)
        if param == escape:
            bits = br.read_bits(5)
            for i in range(count):
                residual[idx + i] = br.read_signed(bits) if bits else 0
        else:
            for i in range(count):
                q = br.read_unary()
                r = br.read_bits(param) if param else 0
                v = (q << param) | r
                residual[idx + i] = (v >> 1) ^ -(v & 1)  # zigzag
        idx += count
    return residual


def _decode_subframe(br: _BitReader, block_size: int, bps: int) -> np.ndarray:
    if br.read_bits(1) != 0:
        raise ValueError("invalid subframe padding bit")
    sf_type = br.read_bits(6)
    wasted = 0
    if br.read_bits(1):
        wasted = 1 + br.read_unary()
        bps -= wasted

    if sf_type == 0:  # constant
        v = br.read_signed(bps)
        out = np.full(block_size, v, np.int64)
    elif sf_type == 1:  # verbatim
        out = np.array([br.read_signed(bps) for _ in range(block_size)], np.int64)
    elif 8 <= sf_type <= 12:  # fixed
        order = sf_type - 8
        warm = [br.read_signed(bps) for _ in range(order)]
        residual = _decode_residual(br, block_size, order)
        out = np.empty(block_size, np.int64)
        out[:order] = warm
        coeffs = _FIXED_COEFFS[order]
        for i in range(order, block_size):
            pred = 0
            for j, c in enumerate(coeffs):
                pred += c * out[i - 1 - j]
            out[i] = residual[i - order] + pred
    elif sf_type >= 32:  # LPC
        order = sf_type - 31
        warm = [br.read_signed(bps) for _ in range(order)]
        precision = br.read_bits(4) + 1
        shift = br.read_signed(5)
        coeffs = [br.read_signed(precision) for _ in range(order)]
        residual = _decode_residual(br, block_size, order)
        out = np.empty(block_size, np.int64)
        out[:order] = warm
        carr = np.array(coeffs, np.int64)
        for i in range(order, block_size):
            pred = int(np.dot(carr, out[i - order : i][::-1])) >> shift
            out[i] = residual[i - order] + pred
    else:
        raise ValueError(f"reserved subframe type {sf_type}")

    if wasted:
        out <<= wasted
    return out


def read_flac_bytes(data: bytes) -> tuple[np.ndarray, int]:
    """Decode a FLAC stream -> (float32 mono audio in [-1,1], sample_rate).

    Uses the wl_native C++ decoder when built (the repository's top-level
    csrc/, ~100x faster on one core); this pure-Python implementation is
    the verified fallback.
    """
    try:
        import wl_native

        pcm_bytes, sr = wl_native.decode_flac(data)
        return np.frombuffer(pcm_bytes, np.float32).copy(), sr
    except ImportError:
        pass
    return _read_flac_bytes_py(data)


def _read_flac_bytes_py(data: bytes) -> tuple[np.ndarray, int]:
    if data[:4] != b"fLaC":
        raise ValueError("not a FLAC stream")
    pos = 4
    sample_rate = None
    n_channels = None
    bps = None
    total_samples = 0
    # metadata blocks
    while True:
        header = data[pos : pos + 4]
        last = header[0] & 0x80
        btype = header[0] & 0x7F
        length = struct.unpack(">I", b"\x00" + header[1:4])[0]
        body = data[pos + 4 : pos + 4 + length]
        if btype == 0:  # STREAMINFO
            br = _BitReader(body)
            br.read_bits(16)  # min block
            br.read_bits(16)  # max block
            br.read_bits(24)  # min frame
            br.read_bits(24)  # max frame
            sample_rate = br.read_bits(20)
            n_channels = br.read_bits(3) + 1
            bps = br.read_bits(5) + 1
            total_samples = br.read_bits(36)
        pos += 4 + length
        if last:
            break
    if sample_rate is None:
        raise ValueError("missing STREAMINFO")

    channels_out: list[np.ndarray] = [np.empty(0, np.int64) for _ in range(n_channels)]
    chunks: list[list[np.ndarray]] = [[] for _ in range(n_channels)]

    br = _BitReader(data, pos)
    total = len(data)
    while br.pos < total - 2:
        # frame header
        sync = br.read_bits(14)
        if sync != 0x3FFE:
            raise ValueError(f"lost frame sync at byte {br.pos}")
        br.read_bits(1)  # reserved
        br.read_bits(1)  # blocking strategy
        bs_code = br.read_bits(4)
        sr_code = br.read_bits(4)
        ch_code = br.read_bits(4)
        ss_code = br.read_bits(3)
        br.read_bits(1)  # reserved
        _read_utf8_number(br)  # frame/sample number
        if bs_code == 6:
            block_size = br.read_bits(8) + 1
        elif bs_code == 7:
            block_size = br.read_bits(16) + 1
        else:
            block_size = _BLOCK_SIZES[bs_code]
        if sr_code == 12:
            br.read_bits(8)
        elif sr_code in (13, 14):
            br.read_bits(16)
        frame_bps = _SAMPLE_SIZES.get(ss_code, bps)
        br.read_bits(8)  # CRC-8

        if ch_code < 8:
            nch = ch_code + 1
            subframes = [_decode_subframe(br, block_size, frame_bps) for _ in range(nch)]
        elif ch_code == 8:  # left/side
            left = _decode_subframe(br, block_size, frame_bps)
            side = _decode_subframe(br, block_size, frame_bps + 1)
            subframes = [left, left - side]
        elif ch_code == 9:  # right/side
            side = _decode_subframe(br, block_size, frame_bps + 1)
            right = _decode_subframe(br, block_size, frame_bps)
            subframes = [right + side, right]
        elif ch_code == 10:  # mid/side
            mid = _decode_subframe(br, block_size, frame_bps)
            side = _decode_subframe(br, block_size, frame_bps + 1)
            m2 = (mid << 1) | (side & 1)
            subframes = [(m2 + side) >> 1, (m2 - side) >> 1]
        else:
            raise ValueError(f"bad channel assignment {ch_code}")

        br.align()
        br.read_bits(16)  # CRC-16
        for c in range(n_channels):
            chunks[c].append(subframes[c])
        if total_samples and sum(len(x) for x in chunks[0]) >= total_samples:
            break

    for c in range(n_channels):
        channels_out[c] = np.concatenate(chunks[c]) if chunks[c] else np.empty(0, np.int64)
    if total_samples:
        channels_out = [c[:total_samples] for c in channels_out]
    pcm = np.stack(channels_out, axis=1).astype(np.float64)
    pcm /= float(1 << (bps - 1))
    mono = pcm.mean(axis=1).astype(np.float32)
    return mono, sample_rate


def read_flac(path: str) -> tuple[np.ndarray, int]:
    with open(path, "rb") as f:
        return read_flac_bytes(f.read())
