"""TLS-syntax (RFC 8446 presentation language) codec primitives.

Equivalent of the `prio::codec` surface the reference's messages crate
builds on (Encode/Decode/encode_u16_items etc., SURVEY.md section 2.2):
big-endian fixed-width integers and length-prefixed opaque vectors.

The port's own copy of janus_tpu/messages/codec.py, line for line; it holds no JAX
and the port imports nothing of janus_tpu.
"""

from __future__ import annotations

import struct


class DecodeError(ValueError):
    pass


class Encoder:
    __slots__ = ("_parts",)

    def __init__(self):
        self._parts: list[bytes] = []

    def bytes(self) -> bytes:
        return b"".join(self._parts)

    def write(self, raw: bytes) -> "Encoder":
        self._parts.append(raw)
        return self

    def u8(self, v: int) -> "Encoder":
        return self.write(struct.pack(">B", v))

    def u16(self, v: int) -> "Encoder":
        return self.write(struct.pack(">H", v))

    def u32(self, v: int) -> "Encoder":
        return self.write(struct.pack(">I", v))

    def u64(self, v: int) -> "Encoder":
        return self.write(struct.pack(">Q", v))

    def opaque_u8(self, raw: bytes) -> "Encoder":
        assert len(raw) < (1 << 8)
        return self.u8(len(raw)).write(raw)

    def opaque_u16(self, raw: bytes) -> "Encoder":
        assert len(raw) < (1 << 16)
        return self.u16(len(raw)).write(raw)

    def opaque_u32(self, raw: bytes) -> "Encoder":
        assert len(raw) < (1 << 32)
        return self.u32(len(raw)).write(raw)

    def items_u16(self, items) -> "Encoder":
        """u16-length-prefixed (in bytes) list of encodable items."""
        inner = Encoder()
        for it in items:
            it.encode(inner)
        return self.opaque_u16(inner.bytes())

    def items_u32(self, items) -> "Encoder":
        inner = Encoder()
        for it in items:
            it.encode(inner)
        return self.opaque_u32(inner.bytes())


class Decoder:
    __slots__ = ("_buf", "_pos", "_end")

    def __init__(self, buf: bytes, pos: int = 0, end: int | None = None):
        self._buf = buf
        self._pos = pos
        self._end = len(buf) if end is None else end

    @property
    def remaining(self) -> int:
        return self._end - self._pos

    def finish(self) -> None:
        if self.remaining != 0:
            raise DecodeError(f"{self.remaining} trailing bytes")

    def take(self, n: int) -> bytes:
        if self.remaining < n:
            raise DecodeError("unexpected end of input")
        out = self._buf[self._pos : self._pos + n]
        self._pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def u16(self) -> int:
        return struct.unpack(">H", self.take(2))[0]

    def u32(self) -> int:
        return struct.unpack(">I", self.take(4))[0]

    def u64(self) -> int:
        return struct.unpack(">Q", self.take(8))[0]

    def opaque_u8(self) -> bytes:
        return self.take(self.u8())

    def opaque_u16(self) -> bytes:
        return self.take(self.u16())

    def opaque_u32(self) -> bytes:
        return self.take(self.u32())

    def sub(self, n: int) -> "Decoder":
        """A decoder over the next n bytes (consumed from self)."""
        if self.remaining < n:
            raise DecodeError("unexpected end of input")
        d = Decoder(self._buf, self._pos, self._pos + n)
        self._pos += n
        return d

    def items_u16(self, decode_one) -> list:
        d = self.sub(self.u16())
        out = []
        while d.remaining:
            out.append(decode_one(d))
        return out

    def items_u32(self, decode_one) -> list:
        d = self.sub(self.u32())
        out = []
        while d.remaining:
            out.append(decode_one(d))
        return out


# Ping-pong message framing (prio topology::ping_pong): u8 tag, then
# 1 (initialize/finish) or 2 (continue) opaque-u32 fields. DAP embeds
# these messages inline (self-delimiting, no outer length prefix) in
# PrepareInit/PrepareContinue/PrepareStepResult. Single home for the
# tag->field-count mapping; vdaf.wire imports these constants.
PP_INITIALIZE = 0
PP_CONTINUE = 1
PP_FINISH = 2


def decode_pingpong_frame(dec: Decoder) -> bytes:
    """Consume one self-delimiting ping-pong message, return its raw bytes."""
    start = dec._pos
    tag = dec.u8()
    if tag == PP_INITIALIZE or tag == PP_FINISH:
        dec.opaque_u32()
    elif tag == PP_CONTINUE:
        dec.opaque_u32()
        dec.opaque_u32()
    else:
        raise DecodeError(f"bad ping-pong message tag {tag}")
    return dec._buf[start : dec._pos]


def check_pingpong_frame(raw: bytes) -> None:
    """Raise DecodeError unless raw is exactly one ping-pong message."""
    dec = Decoder(raw)
    decode_pingpong_frame(dec)
    dec.finish()


class Codec:
    """Mixin: encode to / decode from bytes via Encoder/Decoder methods."""

    def encode(self, enc: Encoder) -> None:
        raise NotImplementedError

    @classmethod
    def decode(cls, dec: Decoder):
        raise NotImplementedError

    def to_bytes(self) -> bytes:
        enc = Encoder()
        self.encode(enc)
        return enc.bytes()

    @classmethod
    def from_bytes(cls, raw: bytes, *args, **kwargs):
        dec = Decoder(raw)
        out = cls.decode(dec, *args, **kwargs)
        dec.finish()
        return out
