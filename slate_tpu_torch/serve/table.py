"""The autotuned schedule table: persistence and request-path resolution.

Counterpart of ``slate_tpu/serve/table.py``, reading the same committed
artifact (``artifacts/serve/tuned.json``, read-only, in ``slate_tpu``'s
schema), so the same requests resolve the same options in both packages.
Table keys carry ``slate_tpu``'s dtype names (``float64``; see
``serve.cache.dtype_name``).  ``python -m slate_tpu_torch.serve.tune``
writes its own table (``artifacts/serve/tuned_torch.json``) and never this
one.

``slate_tpu.serve.tune`` measures (BcastImpl, Lookahead, nb,
stationary variant) sweeps per cache key with the flight recorder's
``sched.*`` metrics as the objective and writes the winners here as a
versioned committed artifact (``artifacts/serve/tuned.json``).  The
request path then resolves UNSET schedule options through the table:

    explicit option > context manager > environment > tuned > auto

i.e. the existing Option.BcastImpl resolution-chain idiom extended by
one tier — the table only ever speaks when every older tier is silent,
so a user pin (or a sweep's env override) always wins.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Any, Dict, Optional, Tuple

from ..types import MethodGemm, Option, Options, get_option
from .metrics import serve_count

TUNED_SCHEMA = "slate_tpu.serve.tuned_table"
TUNED_VERSION = 1
TUNED_ENV = "SLATE_TPU_SERVE_TUNED"  # path override for the table file
AUTOTUNE_ENV = "SLATE_TPU_AUTOTUNE"  # "0" disables the tuned tier

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_TABLE_PATH = os.path.join(_REPO_ROOT, "artifacts", "serve",
                                  "tuned.json")
# the table this package's tuner writes (it never writes the committed one)
TORCH_TABLE_PATH = os.path.join(_REPO_ROOT, "artifacts", "serve",
                                "tuned_torch.json")

# context override (use_tuned_table): a loaded table dict, None (= pin
# "no table"), or _UNSET (no override active — fall through to files)
_UNSET = object()
_TABLE_CTX: list = [_UNSET]
_TABLE_FILE_CACHE: Dict[str, Dict] = {}


def entry_key(op: str, n: int, dtype: str, grid: Tuple[int, int]) -> str:
    """The table's row identity — matches the executable-cache key's
    schedule-relevant coordinates (batch rides the shape, not the
    schedule; nb is a TUNABLE, so it lives in the entry, not the key)."""
    return f"{op}|n={n}|dtype={dtype}|grid={grid[0]}x{grid[1]}"


def validate_table(doc: Any) -> list:
    errs = []
    if not isinstance(doc, dict):
        return ["tuned table must be an object"]
    if doc.get("schema") != TUNED_SCHEMA:
        errs.append(f"schema must be {TUNED_SCHEMA!r}, got {doc.get('schema')!r}")
    if not isinstance(doc.get("version"), int):
        errs.append("version must be an int")
    entries = doc.get("entries")
    if not isinstance(entries, dict):
        errs.append("entries must map key -> winning options")
        return errs
    for key, e in entries.items():
        if not isinstance(e, dict):
            errs.append(f"{key}: entry must be an object")
            continue
        for field, typ in (("bcast_impl", str), ("lookahead", int),
                           ("nb", int)):
            if field in e and not isinstance(e[field], typ):
                errs.append(f"{key}: {field} must be {typ.__name__}")
    return errs


def load_tuned_table(path: Optional[str] = None) -> Optional[Dict]:
    """The active table: the use_tuned_table context > explicit path >
    $SLATE_TPU_SERVE_TUNED > the committed artifact.  Returns None when
    nothing is available (the resolution chain then just skips the
    tuned tier)."""
    if _TABLE_CTX[-1] is not _UNSET:
        return _TABLE_CTX[-1]
    path = path or os.environ.get(TUNED_ENV) or DEFAULT_TABLE_PATH
    if path in _TABLE_FILE_CACHE:
        return _TABLE_FILE_CACHE[path]
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    if validate_table(doc):
        return None
    _TABLE_FILE_CACHE[path] = doc
    return doc


@contextlib.contextmanager
def use_tuned_table(table: Optional[Dict]):
    """Pin a table dict (or None to disable) for calls inside — the
    testing/sweep hook, same shape as comm.use_bcast_impl."""
    if table is not None:
        errs = validate_table(table)
        if errs:
            raise ValueError(f"invalid tuned table: {errs}")
    _TABLE_CTX.append(table)
    try:
        yield
    finally:
        _TABLE_CTX.pop()


def clear_table_cache() -> None:
    _TABLE_FILE_CACHE.clear()


def lookup(op: str, n: int, dtype: str, grid: Tuple[int, int],
           table: Optional[Dict] = None) -> Optional[Dict]:
    """The winning entry for a request class: exact n first, then the
    nearest tuned n at the same (op, dtype, grid) — serving bins are
    coarse, and a 96-tuned schedule is the best prior for 128."""
    doc = table if table is not None else load_tuned_table()
    if doc is None:
        return None
    entries = doc.get("entries", {})
    exact = entries.get(entry_key(op, n, dtype, grid))
    if exact is not None:
        return exact
    prefix = f"{op}|n="
    suffix = f"|dtype={dtype}|grid={grid[0]}x{grid[1]}"
    best, best_dist = None, None
    for key, e in entries.items():
        if not (key.startswith(prefix) and key.endswith(suffix)):
            continue
        try:
            kn = int(key[len(prefix):-len(suffix)])
        except ValueError:
            continue
        # a schedule tuned at kn is only a credible prior within ~2x of
        # the request size: an nb/depth winner at n=96 says nothing
        # about n=4096, and silence (-> the auto chain) beats a wild
        # extrapolation
        if not (n / 2 <= kn <= n * 2):
            continue
        dist = abs(kn - n)
        if best_dist is None or dist < best_dist:
            best, best_dist = e, dist
    return best


def autotune_enabled(opts: Optional[Options] = None) -> bool:
    """Option.AutoTune resolution: explicit > $SLATE_TPU_AUTOTUNE > on."""
    explicit = get_option(opts, Option.AutoTune)
    if explicit is not None:
        return str(getattr(explicit, "value", explicit)).lower() not in (
            "off", "0", "false")
    return os.environ.get(AUTOTUNE_ENV, "1") not in ("0", "off", "false")


def _bcast_tier_silent() -> bool:
    """True when neither the use_bcast_impl context nor the
    SLATE_TPU_BCAST_IMPL environment pins a lowering — the only state in
    which the tuned tier may speak for Option.BcastImpl."""
    from ..parallel.comm import BCAST_IMPL_ENV, _IMPL_DEFAULT

    return _IMPL_DEFAULT[-1] is None and not os.environ.get(BCAST_IMPL_ENV)


def _raw(opts: Optional[Options], key: Option):
    """Presence-only option lookup: None means genuinely UNSET (unlike
    types.get_option, which falls back to the option's default — the
    tuned tier must slot in BEFORE that default, not after)."""
    if not opts:
        return None
    if key in opts:
        return opts[key]
    if key.value in opts:
        return opts[key.value]
    return None


def resolve_request_options(
    opts: Optional[Options], op: str, n: int, dtype: str,
    grid: Tuple[int, int], table: Optional[Dict] = None,
) -> Dict:
    """Fill a request's UNSET schedule options from the tuned table.

    Returns a plain dict Options mapping: the caller's explicit options
    verbatim, plus — only where every older tier (explicit > context >
    env) is silent — the tuned winners for (op, n, dtype, grid).  With
    no table (or Option.AutoTune off) the input passes through and the
    per-option default chains behave exactly as before (auto)."""
    merged: Dict = dict(opts) if opts else {}
    if not autotune_enabled(opts):
        return merged
    entry = lookup(op, n, dtype, grid, table)
    if entry is None:
        return merged
    used = False
    if (_raw(merged, Option.BcastImpl) is None
            and "bcast_impl" in entry and _bcast_tier_silent()):
        merged[Option.BcastImpl] = entry["bcast_impl"]
        used = True
    if _raw(merged, Option.Lookahead) is None and "lookahead" in entry:
        merged[Option.Lookahead] = int(entry["lookahead"])
        used = True
    if _raw(merged, Option.BlockSize) is None and "nb" in entry:
        merged[Option.BlockSize] = int(entry["nb"])
        used = True
    if (op == "gemm" and _raw(merged, Option.MethodGemm) is None
            and "method" in entry):
        merged[Option.MethodGemm] = MethodGemm(entry["method"])
        used = True
    if used:
        serve_count("tuned_resolutions")
    return merged


def write_table(path: str, entries: Dict[str, Dict],
                config: Optional[Dict] = None) -> str:
    """Persist a tuned table as the versioned committed artifact."""
    import time

    from ..obs.report import _env_info

    doc = {
        "schema": TUNED_SCHEMA,
        "version": TUNED_VERSION,
        "created_unix": time.time(),
        "env": _env_info(),
        "config": dict(config or {}),
        "entries": entries,
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
    clear_table_cache()
    return path
