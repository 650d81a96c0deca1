"""Differential privacy for aggregate shares.

The reference's DP surface at this version is the taskprov `DpConfig`
wire message with mechanisms Reserved|None (messages/src/taskprov.rs
DpMechanism) — no noise is ever applied. This module goes further and
implements a working zCDP strategy: each aggregator adds exact
discrete-Gaussian noise to its own aggregate share before release, so
the collector's unsharded result carries the summed noise of both
parties (sigma_total = sqrt(2) * sigma per party).

Sampler: the exact discrete Gaussian of Canonne-Kamath-Steinke
(NeurIPS 2020, "The Discrete Gaussian for Differential Privacy"):
rejection-sample a discrete Laplace from Bernoulli(exp(-x/t)) draws,
then accept with a Gaussian correction — no floating-point error in
the distribution's tails, which matters for DP guarantees.

The port's own copy of janus_tpu/dp.py, line for line. Every draw goes
through this module's `secrets` calls, so a test can feed both packages
one seeded stream and get the same noise.
"""

from __future__ import annotations

import math
import secrets
from dataclasses import dataclass
from fractions import Fraction


def _bernoulli(p: Fraction) -> bool:
    """Exact Bernoulli(p) for rational p in [0, 1]."""
    assert 0 <= p <= 1
    # sample a uniform rational in [0,1) bit by bit against p
    num, den = p.numerator, p.denominator
    r = secrets.randbelow(den)
    return r < num


def _bernoulli_exp_frac(gamma: Fraction) -> bool:
    """Bernoulli(exp(-gamma)) for gamma in [0, 1] (CKS algorithm 1)."""
    k = 1
    while True:
        if not _bernoulli(gamma / k):
            return k % 2 == 1
        k += 1


def _bernoulli_exp(gamma: Fraction) -> bool:
    """Bernoulli(exp(-gamma)) for any gamma >= 0."""
    while gamma > 1:
        if not _bernoulli_exp_frac(Fraction(1)):
            return False
        gamma -= 1
    return _bernoulli_exp_frac(gamma)


def _discrete_laplace(t: int) -> int:
    """Discrete Laplace with scale t (CKS algorithm 2): P[X=x] ∝ exp(-|x|/t)."""
    while True:
        u = secrets.randbelow(t)
        if not _bernoulli_exp(Fraction(u, t)):
            continue
        v = 0
        while _bernoulli_exp(Fraction(1)):
            v += 1
        mag = u + t * v
        if secrets.randbelow(2) == 0:
            if mag == 0:
                continue
            return -mag
        return mag


def discrete_gaussian(sigma: Fraction) -> int:
    """Exact discrete Gaussian: P[X=x] ∝ exp(-x^2 / (2 sigma^2))."""
    sigma = Fraction(sigma)
    t = math.floor(sigma) + 1
    sigma2 = sigma * sigma
    while True:
        y = _discrete_laplace(t)
        gamma = (abs(y) - sigma2 / t) ** 2 / (2 * sigma2)
        if _bernoulli_exp(gamma):
            return y


@dataclass(frozen=True)
class DpStrategy:
    """Per-task DP configuration applied by each aggregator to its own
    aggregate share at release time."""

    mechanism: str = "none"  # "none" | "discrete_gaussian"
    sigma: float = 0.0  # per-party noise scale, in field units

    def to_dict(self) -> dict:
        return {"mechanism": self.mechanism, "sigma": self.sigma}

    @classmethod
    def from_dict(cls, d: dict | None) -> "DpStrategy":
        if not d:
            return cls()
        return cls(mechanism=d.get("mechanism", "none"), sigma=float(d.get("sigma", 0.0)))

    @property
    def enabled(self) -> bool:
        return self.mechanism == "discrete_gaussian" and self.sigma > 0


def add_noise_to_agg_share(strategy: DpStrategy, field, share: bytes | None) -> bytes | None:
    """Add per-element discrete-Gaussian noise (mod p) to an encoded
    aggregate share. No-op for mechanism 'none' or an empty share."""
    if share is None or not strategy.enabled:
        return share
    sigma = Fraction(strategy.sigma).limit_denominator(1 << 20)
    vec = field.decode_vec(share)
    noised = [field.add(x, discrete_gaussian(sigma) % field.MODULUS) for x in vec]
    return field.encode_vec(noised)
