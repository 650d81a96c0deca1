"""Host-side field arithmetic on Python ints.

Used for precomputing constants (NTT twiddles, inverses) that are
shipped to the device as tensors, and as the oracle the tests hold the
tensor fields against. The moduli are the VDAF-07 fields Prio3 uses:

  Field64  : p = 2^64 - 2^32 + 1          (2-adicity 32)
  Field128 : p = 2^128 - 7*2^66 + 1       (2-adicity 66)
"""

from __future__ import annotations


class _FieldMeta(type):
    def __repr__(cls):
        return cls.__name__


class Field(metaclass=_FieldMeta):
    """A prime field. Subclasses set MODULUS, GEN, NUM_ROOTS_LOG2, ENCODED_SIZE."""

    MODULUS: int
    GEN: int  # multiplicative group generator
    NUM_ROOTS_LOG2: int  # 2-adicity: 2^k | p-1
    ENCODED_SIZE: int  # bytes, little-endian

    @classmethod
    def add(cls, a: int, b: int) -> int:
        return (a + b) % cls.MODULUS

    @classmethod
    def sub(cls, a: int, b: int) -> int:
        return (a - b) % cls.MODULUS

    @classmethod
    def mul(cls, a: int, b: int) -> int:
        return (a * b) % cls.MODULUS

    @classmethod
    def pow(cls, a: int, e: int) -> int:
        return pow(a, e, cls.MODULUS)

    @classmethod
    def inv(cls, a: int) -> int:
        return pow(a, cls.MODULUS - 2, cls.MODULUS)

    @classmethod
    def root_of_unity(cls, order: int) -> int:
        """Primitive `order`-th root of unity; order must be a power of two."""
        assert order & (order - 1) == 0
        assert order <= 1 << cls.NUM_ROOTS_LOG2
        return pow(cls.GEN, (cls.MODULUS - 1) // order, cls.MODULUS)

    @classmethod
    def encode(cls, a: int) -> bytes:
        return a.to_bytes(cls.ENCODED_SIZE, "little")

    @classmethod
    def decode(cls, data: bytes) -> int:
        assert len(data) == cls.ENCODED_SIZE
        v = int.from_bytes(data, "little")
        if v >= cls.MODULUS:
            raise ValueError("field element out of range")
        return v

    @classmethod
    def encode_vec(cls, vec) -> bytes:
        return b"".join(cls.encode(int(x)) for x in vec)

    @classmethod
    def decode_vec(cls, data: bytes) -> list[int]:
        n = cls.ENCODED_SIZE
        if len(data) % n:
            raise ValueError("bad field vector length")
        return [cls.decode(data[i : i + n]) for i in range(0, len(data), n)]


class Field64(Field):
    MODULUS = 2**64 - 2**32 + 1  # 18446744069414584321
    GEN = 7
    NUM_ROOTS_LOG2 = 32
    ENCODED_SIZE = 8


class Field128(Field):
    MODULUS = 2**128 - 7 * 2**66 + 1  # 340282366920938462946865773367900766209
    GEN = 7
    NUM_ROOTS_LOG2 = 66
    ENCODED_SIZE = 16
