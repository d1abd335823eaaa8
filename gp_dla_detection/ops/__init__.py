"""Numerics: Faddeeva/Voigt profiles, low-rank GP algebra,
interpolation and optimization."""

from .faddeeva import voigt_function, wofz_real
from .low_rank_mvn import (
    batched_dla_log_likelihoods,
    log_mvnpdf_low_rank,
    pair_products,
    woodbury_log_p,
)
from .voigt import instrumental_broadening, voigt_absorption

__all__ = [
    "voigt_function",
    "wofz_real",
    "batched_dla_log_likelihoods",
    "log_mvnpdf_low_rank",
    "pair_products",
    "woodbury_log_p",
    "instrumental_broadening",
    "voigt_absorption",
]
