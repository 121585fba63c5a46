"""Binary buffer: the byte-level serialization primitive.

Host copy of `plonky2_tpu/serialization/buffer.py`: little-endian
fixed-width integers, u32 length prefixes for lists and strings, Goldilocks
elements as u64, extension elements as 2 u64s, digests as 4 u64s, and a
u8 tag (prover data's targets).  The JAX buffer's bool fields are left
out: no format of the port uses them.
"""

from __future__ import annotations

import struct

from ..field import gl


class Buffer:
    def __init__(self, data: bytes = b""):
        self._data = bytearray(data)
        self._pos = 0

    def bytes(self) -> bytes:
        return bytes(self._data)

    def remaining(self) -> int:
        return len(self._data) - self._pos

    # ---- writers ----

    def write_u8(self, v: int) -> None:
        self._data += struct.pack("<B", v)

    def write_u32(self, v: int) -> None:
        self._data += struct.pack("<I", v)

    def write_u64(self, v: int) -> None:
        self._data += struct.pack("<Q", v)

    def write_field(self, v: int) -> None:
        if not 0 <= v < gl.P:
            raise ValueError(f"non-canonical field element {v}")
        self.write_u64(v)

    def write_ext(self, v) -> None:
        c0, c1 = v
        self.write_field(int(c0))
        self.write_field(int(c1))

    def write_digest(self, d) -> None:
        if len(d) != 4:
            raise ValueError(f"digest has {len(d)} elements")
        for e in d:
            self.write_field(int(e))

    def write_str(self, s: str) -> None:
        raw = s.encode()
        self.write_u32(len(raw))
        self._data += raw

    def write_list(self, xs, write_elem) -> None:
        self.write_u32(len(xs))
        for x in xs:
            write_elem(x)

    # ---- readers ----

    def _take(self, n: int) -> bytes:
        if self._pos + n > len(self._data):
            raise EOFError("buffer exhausted")
        out = bytes(self._data[self._pos:self._pos + n])
        self._pos += n
        return out

    def read_u8(self) -> int:
        return struct.unpack("<B", self._take(1))[0]

    def read_u32(self) -> int:
        return struct.unpack("<I", self._take(4))[0]

    def read_u64(self) -> int:
        return struct.unpack("<Q", self._take(8))[0]

    def read_field(self) -> int:
        v = self.read_u64()
        if v >= gl.P:
            raise ValueError(f"non-canonical field element {v}")
        return v

    def read_ext(self):
        return (self.read_field(), self.read_field())

    def read_digest(self):
        return [self.read_field() for _ in range(4)]

    def read_str(self) -> str:
        return self._take(self.read_u32()).decode()

    def read_list(self, read_elem) -> list:
        return [read_elem() for _ in range(self.read_u32())]
