"""Solver recipes: which convergence math a beta-divergence solve runs.

Port of ``cnmf_torch_tpu/ops/recipe.py`` with the same words, precedence
and errors, so one environment resolves one recipe in both packages:

* ``mu`` — plain alternating multiplicative updates;
* ``amu`` — accelerated MU (Gillis & Glineur, arXiv:1107.5194):
  ``inner_repeats`` H sub-iterations per W update, each lane leaving the
  repeats early once its relative H change stagnates;
* ``dna`` — Diagonalized Newton for KL (Van hamme, arXiv:1301.3389):
  diagonal-Hessian H steps clipped at zero, with a per-row MU fallback
  chosen by comparing the two candidates' exact row objectives, so the
  composite is monotone like MU;
* ``hals`` — hierarchical ALS for the Frobenius loss (``algo="halsvar"``);
* ``sketch`` — sketched KL W updates (arXiv:1604.04026): each W update
  from a row subsample, with exact updates interleaved
  (``ops/nmf.py``).

Resolution order: explicit caller arguments > env knobs > the auto
heuristic. Knobs (``utils/envknobs.py``): ``CNMF_TPU_ACCEL`` (``auto`` by
default: batch KL resolves to ``dna``, batch IS to ``amu``; ``0`` pins
plain MU; ``1`` forces acceleration wherever the recipe is defined),
``CNMF_TPU_INNER_REPEATS``, ``CNMF_TPU_KL_NEWTON``, ``CNMF_TPU_SKETCH``,
``CNMF_TPU_SKETCH_DIM`` and ``CNMF_TPU_SKETCH_EXACT_EVERY``.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..utils.envknobs import env_flag, env_int, env_str

__all__ = ["SolverRecipe", "resolve_recipe", "auto_inner_repeats",
           "auto_sketch_rows", "ACCEL_ENV", "INNER_REPEATS_ENV",
           "KL_NEWTON_ENV", "SKETCH_ENV", "SKETCH_DIM_ENV",
           "SKETCH_EXACT_EVERY_ENV", "DEFAULT_SKETCH_EXACT_EVERY"]

ACCEL_ENV = "CNMF_TPU_ACCEL"
INNER_REPEATS_ENV = "CNMF_TPU_INNER_REPEATS"
KL_NEWTON_ENV = "CNMF_TPU_KL_NEWTON"
SKETCH_ENV = "CNMF_TPU_SKETCH"
SKETCH_DIM_ENV = "CNMF_TPU_SKETCH_DIM"
SKETCH_EXACT_EVERY_ENV = "CNMF_TPU_SKETCH_EXACT_EVERY"

DEFAULT_SKETCH_EXACT_EVERY = 4

_OFF_WORDS = ("", "0", "off", "false", "no")
_ON_WORDS = ("1", "on", "true", "yes", "force")


@dataclass(frozen=True)
class SolverRecipe:
    """One resolved iteration scheme for a beta-divergence solve.

    ``algo``: ``mu`` | ``amu`` | ``dna`` | ``hals`` | ``sketch``.
    ``inner_repeats``: H sub-iterations per W update (``amu`` only; 1
    otherwise). ``kl_newton``: the beta=1 H updates run diagonal-Newton
    steps with the MU fallback lane (``dna`` only). ``source`` records who
    decided (``default`` / ``env`` / ``auto`` / ``caller``).
    """

    algo: str = "mu"
    inner_repeats: int = 1
    kl_newton: bool = False
    source: str = "default"
    sketch_dim: int = 0
    sketch_exact_every: int = 1

    def __post_init__(self):
        if self.algo not in ("mu", "amu", "dna", "hals", "sketch"):
            raise ValueError(f"unknown recipe algo {self.algo!r}")
        if self.inner_repeats < 1:
            raise ValueError(
                f"inner_repeats={self.inner_repeats}: must be >= 1")
        if self.kl_newton and self.algo != "dna":
            raise ValueError("kl_newton is the dna recipe's flag")
        if self.algo == "sketch":
            if self.sketch_dim < 1:
                raise ValueError(
                    "the sketch recipe needs sketch_dim >= 1 sampled rows")
            if self.sketch_exact_every < 1:
                raise ValueError(
                    f"sketch_exact_every={self.sketch_exact_every}: "
                    "must be >= 1")
            if self.inner_repeats != 1 or self.kl_newton:
                raise ValueError(
                    "the sketch recipe is exclusive with amu/dna fields")
        elif self.sketch_dim:
            raise ValueError("sketch_dim is the sketch recipe's field")

    @property
    def label(self) -> str:
        """``mu``, ``amu(rho=3)``, ``dna``, ``hals``, ``sketch(m=512,E=4)``."""
        if self.algo == "amu":
            return f"amu(rho={self.inner_repeats})"
        if self.algo == "sketch":
            return (f"sketch(m={self.sketch_dim},"
                    f"E={self.sketch_exact_every})")
        return self.algo

    def signature(self) -> str:
        """The JAX package's stable string for a pass checkpoint's
        identity: two runs whose signatures differ must not splice their
        trajectories."""
        sig = (f"algo={self.algo},rho={int(self.inner_repeats)},"
               f"newton={int(self.kl_newton)}")
        if self.algo == "sketch":
            sig += (f",skdim={int(self.sketch_dim)},"
                    f"skE={int(self.sketch_exact_every)}")
        return sig

    def as_context(self) -> dict:
        """The telemetry ``solver_recipe`` dispatch event's context."""
        return {"recipe": self.label, "algo": self.algo,
                "inner_repeats": int(self.inner_repeats),
                "kl_newton": bool(self.kl_newton), "source": self.source,
                "sketch_dim": int(self.sketch_dim),
                "sketch_exact_every": int(self.sketch_exact_every)}


def auto_sketch_rows(n: int | None) -> int:
    """Default sampled-row count of the sketched W update: n/8 clamped to
    [256, n]; 2048 when ``n`` is unknown."""
    if not n:
        return 2048
    return int(max(min(256, n), min(n, n // 8)))


def _measured_rho_scale(beta: float, ell: bool):
    """The measured correction to the static amu cost ratio, from the
    per-device autotune cache (``utils/autotune.py``); ``None`` (the
    static ratio stands) when no cache exists or ``CNMF_TPU_AUTOTUNE=0``."""
    from ..utils.autotune import cached_rho_scale

    return cached_rho_scale(beta, ell=ell)


def auto_inner_repeats(beta: float, n: int | None = None,
                       g: int | None = None, k: int | None = None,
                       ell_width: int | None = None,
                       ell: bool = False) -> int:
    """rho from the arXiv:1107.5194 cost ratio: 1 + (W-update flops) //
    (H-repeat flops), clamped to [2, 8]: beta=2 repeats are k-sized
    (rho 8), ELL beta in {1, 0} repeats cost (2k+2)/(4k+2) of a W update
    (rho 3), dense beta in {1, 0} repeats cost a full WH pass (rho 2)."""
    beta = float(beta)
    ell = bool(ell) or ell_width is not None
    if n and g and k:
        if beta == 2.0:
            h_rep = n * k * k
            w_upd = 2 * n * g * k
        elif ell_width:
            h_rep = n * ell_width * (2 * k + 2)
            w_upd = n * ell_width * (4 * k + 2)
        elif ell:
            # the width cancels in the ELL ratio: rho=3 for any width
            return 3
        else:
            h_rep = 2 * n * g * k
            w_upd = 2 * n * g * k
        ratio = w_upd / max(h_rep, 1)
        scale = _measured_rho_scale(beta, ell)
        if scale is not None:
            return int(max(2, min(12, 1 + round(ratio * scale))))
        return int(max(2, min(8, 1 + round(ratio))))
    if beta == 2.0:
        return 8
    return 3 if ell else 2


def resolve_recipe(beta: float, mode: str, *, algo: str = "mu",
                   ell: bool = False, n: int | None = None,
                   g: int | None = None, k: int | None = None,
                   ell_width: int | None = None,
                   accel: str | None = None,
                   inner_repeats: int | None = None,
                   kl_newton: bool | None = None,
                   sketch: str | None = None,
                   sketch_dim: int | None = None,
                   sketch_exact_every: int | None = None) -> SolverRecipe:
    """Resolve the solver recipe for one (beta, mode) solve.

    ``mode``: ``batch`` | ``online`` | ``rowshard``. ``algo`` is the
    ledger's algorithm (``mu``, or ``halsvar``, which maps to ``hals``).
    Explicit ``accel`` / ``inner_repeats`` / ``kl_newton`` / ``sketch*``
    arguments win over the env knobs. ``sketch`` engages for beta=1
    anywhere (and wins over the accel lanes when both are forced); ``dna``
    for beta=1 in every mode; ``amu`` in batch solves only.
    """
    beta = float(beta)
    if algo in ("hals", "halsvar"):
        return SolverRecipe("hals", 1, False, "caller")
    if algo != "mu":
        raise ValueError(f"unknown solver algo {algo!r}")

    if sketch is None:
        sk_raw, sk_src = env_str(SKETCH_ENV, "0"), "env"
    else:
        sk_raw, sk_src = str(sketch), "caller"
    sk_raw = sk_raw.strip().lower()
    if sk_raw not in _OFF_WORDS + _ON_WORDS + ("auto",):
        raise ValueError(
            f"{SKETCH_ENV}={sk_raw!r}: expected 0, 1, or auto")
    # an env-sourced sketch word does not override a caller who pinned
    # the accel family's fields; a caller-passed ``sketch`` wins outright
    caller_pinned_accel = (accel is not None or inner_repeats is not None
                           or kl_newton is not None)
    if (sk_raw in _ON_WORDS and beta == 1.0
            and not (sketch is None and caller_pinned_accel)):
        m = sketch_dim
        if m is None:
            raw_dim = env_str(SKETCH_DIM_ENV, "auto").strip().lower()
            m = 0 if raw_dim in ("", "auto") \
                else (env_int(SKETCH_DIM_ENV, 0, lo=0) or 0)
        if not m:
            # the measured sketch-rows point (utils/autotune.py) wins over
            # the static n/8; the env and caller pins above win outright
            from ..utils.autotune import cached_plan_point

            m = cached_plan_point("sketch_dim")
            m = int(m) if m else auto_sketch_rows(n)
        if n:
            m = min(int(m), int(n))
        E = sketch_exact_every
        if E is None:
            E = env_int(SKETCH_EXACT_EVERY_ENV,
                        DEFAULT_SKETCH_EXACT_EVERY, lo=1)
        return SolverRecipe("sketch", 1, False, sk_src,
                            sketch_dim=int(m), sketch_exact_every=int(E))

    if accel is None:
        accel_raw, source = env_str(ACCEL_ENV, "auto"), "env"
    else:
        accel_raw, source = str(accel), "caller"
    accel_raw = accel_raw.strip().lower()
    if accel_raw in _OFF_WORDS:
        return SolverRecipe("mu", 1, False,
                            "default" if accel is None else source)
    if accel_raw in _ON_WORDS:
        engaged = True
    elif accel_raw == "auto":
        # batch beta in {1, 0} MU solves, where the iteration count
        # dominates
        engaged = mode == "batch" and beta in (1.0, 0.0)
        source = source if accel is not None else "auto"
    else:
        raise ValueError(
            f"{ACCEL_ENV}={accel_raw!r}: expected 0, 1, or auto")
    if not engaged:
        return SolverRecipe("mu", 1, False, source)

    if kl_newton is None:
        kl_newton = env_flag(KL_NEWTON_ENV, True)
    if kl_newton and beta == 1.0:
        return SolverRecipe("dna", 1, True, source)
    if mode == "batch":
        rho = inner_repeats
        if rho is None:
            raw = env_str(INNER_REPEATS_ENV, "auto").strip().lower()
            rho = 0 if raw in ("", "auto") \
                else (env_int(INNER_REPEATS_ENV, 0, lo=0) or 0)
        if not rho:
            rho = auto_inner_repeats(beta, n, g, k,
                                     ell_width=ell_width if ell else None,
                                     ell=ell)
        if int(rho) > 1:
            return SolverRecipe("amu", int(rho), False, source)
    return SolverRecipe("mu", 1, False, source)
