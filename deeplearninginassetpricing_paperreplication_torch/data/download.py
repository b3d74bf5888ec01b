"""Real-data acquisition: the authors' 1.2 GB .npz panel from Google Drive.

The port's copy of the JAX package's ``data/download.py`` (stdlib and numpy
only), the counterpart of the reference's ``src/download_data.py``
(pointers and expected sizes from its lines 31-45). The `gdown` dependency
is hard-gated: everything except the actual network pull
(existence checks, size validation, restructuring) works without it, and the
synthetic generator (``data/synthetic.py``) is the offline substitute.

Layout produced:
    data_dir/char/Char_{train,valid,test}.npz
    data_dir/macro/macro_{train,valid,test}.npz
"""

from __future__ import annotations

import argparse
import shutil
import zipfile
from pathlib import Path
from typing import Dict, List, Tuple, Union

# Authors' Google Drive (Chen-Pelger-Zhu replication data)
DATASETS_ZIP_ID = "1h9O7YwPLaRBbghtF50Cr-JmIq0aHHi4Y"
GDRIVE_FOLDER_ID = "1TrYzMUA_xLID5-gXOy_as8sH2ahLwz-l"

EXPECTED_SIZES_BYTES: Dict[str, int] = {
    "Char_train.npz": 317 * 1024 * 1024,
    "Char_valid.npz": 72 * 1024 * 1024,
    "Char_test.npz": 768 * 1024 * 1024,
    "macro_train.npz": 351 * 1024,
    "macro_valid.npz": 96 * 1024,
    "macro_test.npz": 436 * 1024,
}

REQUIRED_FILES: List[Tuple[str, str]] = [
    ("char", "Char_train.npz"),
    ("char", "Char_valid.npz"),
    ("char", "Char_test.npz"),
    ("macro", "macro_train.npz"),
    ("macro", "macro_valid.npz"),
    ("macro", "macro_test.npz"),
]


def check_data_exists(data_dir: Union[str, Path], verbose: bool = True) -> bool:
    """True iff all six .npz files are present (download_data.py:48-76)."""
    data_dir = Path(data_dir)
    missing = [
        sub + "/" + name
        for sub, name in REQUIRED_FILES
        if not (data_dir / sub / name).exists()
    ]
    if verbose:
        if missing:
            print(f"Missing {len(missing)}/6 data files under {data_dir}:")
            for m in missing:
                print(f"  - {m}")
        else:
            print(f"All 6 data files present under {data_dir}")
    return not missing


def validate_sizes(data_dir: Union[str, Path], tolerance: float = 0.5) -> Dict[str, bool]:
    """Compare on-disk sizes against the expected table (±tolerance)."""
    data_dir = Path(data_dir)
    out = {}
    for sub, name in REQUIRED_FILES:
        p = data_dir / sub / name
        if not p.exists():
            out[name] = False
            continue
        expected = EXPECTED_SIZES_BYTES[name]
        out[name] = abs(p.stat().st_size - expected) <= tolerance * expected
    return out


def validate_schema(data_dir: Union[str, Path], verbose: bool = True):
    """Deep-validate whatever landed in `data_dir` against the npz schema the
    loader assumes (shapes, dtypes, date format, sentinel convention) — a
    loud pass/fail BEFORE a user points training at real downloaded bytes.

    The Drive download path has never been exercised against the live
    1.2 GB artifacts (the schema is taken from the reference's
    ``src/download_data.py:347-375`` and its loader's conventions), which
    is why a user with the real files gets this validator instead of a
    trust-me.

    Checks per char file: `data` [T, N, 1+F] float with returns in slice 0,
    no NaN/Inf (missing entries must use the -99.99 sentinel, not NaN),
    `date` [T] monotonically increasing YYYYMM ints, `variable` [1+F].
    Per macro file: `data` [T, M] float, finite, `date` [T] matching the
    char split's dates. Cross-split: F and N consistent, M consistent.

    Returns (ok, report) where report maps filename → dict with `shape` and
    an `errors` list (empty = pass).
    """
    import numpy as np

    data_dir = Path(data_dir)
    report: Dict[str, Dict] = {}
    char_meta: Dict[str, Dict] = {}
    macro_meta: Dict[str, Dict] = {}

    def _check_dates(date, T, errors):
        if date.shape != (T,):
            errors.append(f"date shape {date.shape} != ({T},)")
            return
        d = date.astype(np.int64)
        months = d % 100
        if not ((d >= 190001) & (d <= 210012) & (months >= 1)
                & (months <= 12)).all():
            errors.append("date entries are not YYYYMM ints in [190001, 210012]")
        if T > 1 and not (np.diff(d) > 0).all():
            errors.append("dates are not strictly increasing")

    def _check_file(sub, name, data, date, variable, info, errors):
        info["shape"] = tuple(data.shape)
        if not np.issubdtype(data.dtype, np.floating):
            errors.append(f"data dtype {data.dtype} is not floating")
            return
        if sub == "char":
            if data.ndim != 3 or data.shape[2] < 2:
                errors.append(
                    f"char data must be [T, N, 1+F] with F>=1, got {data.shape}")
                return
            T, N, one_plus_f = data.shape
            if not np.isfinite(data).all():
                errors.append(
                    "char data contains NaN/Inf — missing entries must use "
                    "the -99.99 sentinel the loader masks on")
            info["missing_frac"] = float(
                np.isclose(data[..., 1:], -99.99, atol=1e-4).mean())
            if variable is not None and variable.shape[0] != one_plus_f:
                errors.append(
                    f"variable has {variable.shape[0]} names for "
                    f"{one_plus_f} data channels")
            _check_dates(date, T, errors)
            char_meta[name.split("_")[1].split(".")[0]] = {
                "T": T, "N": N, "F": one_plus_f - 1, "date": date,
            }
        else:
            if data.ndim != 2:
                errors.append(f"macro data must be [T, M], got {data.shape}")
                return
            T, M = data.shape
            if not np.isfinite(data).all():
                errors.append("macro data contains NaN/Inf")
            _check_dates(date, T, errors)
            macro_meta[name.split("_")[1].split(".")[0]] = {
                "T": T, "M": M, "date": date,
            }

    for sub, name in REQUIRED_FILES:
        p = data_dir / sub / name
        errors: List[str] = []
        info: Dict = {"errors": errors}
        report[name] = info
        if not p.exists():
            errors.append("missing")
            continue
        try:
            with np.load(p, allow_pickle=False) as z:
                files = set(z.files)
                need = {"data", "date"}
                if missing := need - files:
                    errors.append(f"missing npz keys: {sorted(missing)}")
                    continue
                data = z["data"]
                date = z["date"]
                variable = z["variable"] if "variable" in files else None
        except (OSError, ValueError, zipfile.BadZipFile) as e:
            errors.append(f"unreadable npz: {e}")
            continue
        try:
            _check_file(sub, name, data, date, variable, info, errors)
        except Exception as e:  # noqa: BLE001 — the validator exists for
            # never-before-seen real bytes; ANY surprise (string dates,
            # object arrays, ...) must become a loud per-file error, not an
            # uncaught traceback that kills the report
            errors.append(f"validation error: {e!r}")

    cross: List[str] = []
    if len({m["F"] for m in char_meta.values()}) > 1:
        cross.append(f"inconsistent F across splits: "
                     f"{ {k: v['F'] for k, v in char_meta.items()} }")
    if len({m["N"] for m in char_meta.values()}) > 1:
        cross.append(f"inconsistent N across splits: "
                     f"{ {k: v['N'] for k, v in char_meta.items()} }")
    if len({m["M"] for m in macro_meta.values()}) > 1:
        cross.append(f"inconsistent M across splits: "
                     f"{ {k: v['M'] for k, v in macro_meta.items()} }")
    for split, cm in char_meta.items():
        mm = macro_meta.get(split)
        if mm is None:
            continue
        if cm["T"] != mm["T"]:
            cross.append(f"{split}: char T={cm['T']} != macro T={mm['T']}")
        elif not np.array_equal(cm["date"], mm["date"]):
            cross.append(f"{split}: char and macro dates disagree")
    report["cross_split"] = {"errors": cross}

    ok = all(not info["errors"] for info in report.values())
    if verbose:
        for name, info in report.items():
            status = "ok" if not info["errors"] else "FAIL"
            shape = info.get("shape")
            extra = f" shape={shape}" if shape else ""
            mf = info.get("missing_frac")
            if mf is not None:
                extra += f" missing={mf:.1%}"
            print(f"  [{status}] {name}{extra}")
            for e in info["errors"]:
                print(f"         - {e}")
        print(f"Schema validation: {'PASS' if ok else 'FAIL'}")
    return ok, report


def _require_gdown():
    try:
        import gdown  # noqa

        return gdown
    except ImportError as e:
        raise ImportError(
            "Downloading the real dataset requires `gdown` (not bundled in "
            "this environment). Install it, or use the offline synthetic "
            "generator instead:\n  python -m "
            "deeplearninginassetpricing_paperreplication_torch.data.synthetic "
            "--output_dir ./data"
        ) from e


def restructure_zip(zip_path: Union[str, Path], data_dir: Union[str, Path]) -> None:
    """Unpack datasets.zip and arrange files into char/ and macro/
    (download_data.py:121-159)."""
    data_dir = Path(data_dir)
    (data_dir / "char").mkdir(parents=True, exist_ok=True)
    (data_dir / "macro").mkdir(parents=True, exist_ok=True)
    extract_dir = data_dir / "_extract"
    with zipfile.ZipFile(zip_path) as zf:
        zf.extractall(extract_dir)
    for npz in extract_dir.rglob("*.npz"):
        sub = "char" if npz.name.startswith("Char") else "macro"
        shutil.move(str(npz), str(data_dir / sub / npz.name))
    shutil.rmtree(extract_dir, ignore_errors=True)


def download_from_zip(data_dir: Union[str, Path], quiet: bool = False) -> bool:
    """Pull datasets.zip directly by file id (the fast path,
    download_data.py:79-118)."""
    gdown = _require_gdown()
    data_dir = Path(data_dir)
    data_dir.mkdir(parents=True, exist_ok=True)
    zip_path = data_dir / "datasets.zip"
    url = f"https://drive.google.com/uc?id={DATASETS_ZIP_ID}"
    if not quiet:
        print(f"Downloading {url} → {zip_path} (~1.2 GB)")
    result = gdown.download(url, str(zip_path), quiet=quiet)
    # gdown returns None (without raising) on failure, e.g. Drive quota
    # exceeded — a common state for this public 1.2 GB file
    if result is None or not zip_path.exists() or not zipfile.is_zipfile(zip_path):
        zip_path.unlink(missing_ok=True)
        return False
    restructure_zip(zip_path, data_dir)
    zip_path.unlink(missing_ok=True)
    return True


def download_from_folder(data_dir: Union[str, Path], quiet: bool = False) -> bool:
    """Pull the whole Drive folder, then unpack any datasets.zip inside —
    the fallback when the direct file id hits quota
    (download_data.py:177-263)."""
    gdown = _require_gdown()
    data_dir = Path(data_dir)
    data_dir.mkdir(parents=True, exist_ok=True)
    url = f"https://drive.google.com/drive/folders/{GDRIVE_FOLDER_ID}"
    if not quiet:
        print(f"Downloading Drive folder {url} → {data_dir} (may take a while)")
    try:
        gdown.download_folder(url=url, output=str(data_dir), quiet=quiet,
                              use_cookies=False)
    except Exception as e:  # gdown raises on folder listing failures
        if not quiet:
            print(f"Folder download failed: {e}")
        return False
    zip_path = data_dir / "datasets.zip"
    if zip_path.exists():
        restructure_zip(zip_path, data_dir)
        zip_path.unlink(missing_ok=True)
    # stray macOS metadata folder ships inside the authors' archive
    shutil.rmtree(data_dir / "__MACOSX", ignore_errors=True)
    return check_data_exists(data_dir, verbose=False)


def download_all_data(
    data_dir: Union[str, Path] = "./data",
    force: bool = False,
    quiet: bool = False,
    method: str = "zip",
) -> bool:
    """Fetch + restructure the real panel. `method` is 'zip' (direct file id,
    fast) or 'folder' (whole-folder crawl); on zip failure the folder method
    is tried automatically, mirroring the reference's two methods."""
    if method not in ("zip", "folder"):
        raise ValueError(f"method must be 'zip' or 'folder', got {method!r}")
    data_dir = Path(data_dir)
    if not force and check_data_exists(data_dir, verbose=False):
        if not quiet:
            print("Data already present; use force=True to re-download")
        return True

    ok = False
    if method == "zip":
        ok = download_from_zip(data_dir, quiet=quiet)
        if not ok and not quiet:
            print("zip method failed; falling back to folder method")
    if not ok:
        ok = download_from_folder(data_dir, quiet=quiet)
    if not ok:
        raise RuntimeError(
            "Download failed (Google Drive quota exceeded or network error). "
            "Retry later, download manually from "
            f"https://drive.google.com/drive/folders/{GDRIVE_FOLDER_ID}, or "
            "use the offline synthetic generator:\n  python -m "
            "deeplearninginassetpricing_paperreplication_torch.data.synthetic"
        )
    ok = check_data_exists(data_dir, verbose=not quiet)
    if ok:
        bad = [k for k, v in validate_sizes(data_dir).items() if not v]
        if bad and not quiet:
            print(f"WARNING: unexpected file sizes: {bad}")
    return ok


def print_data_info() -> None:
    """Describe the expected dataset (facts per download_data.py:347-375:
    the Drive source, the six files and their sizes, and the npz schema —
    constants shared with the reference by necessity)."""
    print(f"""
Expected dataset: six .npz files, ~1.2 GB altogether, laid out as

  data/
  ├── char/    firm characteristics + returns, one file per split
  │     Char_train.npz (317 MB)   Char_valid.npz (72 MB)   Char_test.npz (768 MB)
  └── macro/   macroeconomic series, one file per split
        macro_train.npz (351 KB)  macro_valid.npz (96 KB)  macro_test.npz (436 KB)

Where it comes from:
  the authors' Google Drive folder
  https://drive.google.com/drive/folders/{GDRIVE_FOLDER_ID}
  (linked from https://mpelger.people.stanford.edu/data-and-code)

Schema inside each npz:
  char files : data [T, N, 1+F] (slice 0 = returns, 1: = characteristics,
               -99.99 marks missing), date [T] as YYYYMM, variable [1+F]
  macro files: data [T, M], date [T]

No network? Generate a schema-identical seeded panel instead:
  python -m deeplearninginassetpricing_paperreplication_torch.data.synthetic
""")


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Download the real asset-pricing panel",
        epilog="On Drive quota errors, retry later or use --method folder.",
    )
    p.add_argument("--data_dir", "--output_dir", "-o", dest="data_dir",
                   type=str, default="./data")
    p.add_argument("--check", action="store_true",
                   help="Check existence + validate the npz schema "
                        "(shapes/dtypes/dates/sentinel) of what's on disk")
    p.add_argument("--force", "-f", action="store_true")
    p.add_argument("--quiet", "-q", action="store_true")
    p.add_argument("--info", "-i", action="store_true",
                   help="Print data information and exit")
    p.add_argument("--method", "-m", choices=["zip", "folder"], default="zip",
                   help="'zip' = direct datasets.zip pull (fast); "
                        "'folder' = whole Drive folder crawl")
    args = p.parse_args(argv)
    if args.info:
        print_data_info()
        return
    if args.check:
        ok = check_data_exists(args.data_dir)
        if ok:
            for sub, name in REQUIRED_FILES:
                f = Path(args.data_dir) / sub / name
                print(f"  {f} ({f.stat().st_size / (1024 * 1024):.1f} MB)")
            ok, _ = validate_schema(args.data_dir)
        raise SystemExit(0 if ok else 1)
    ok = download_all_data(args.data_dir, force=args.force, quiet=args.quiet,
                           method=args.method)
    raise SystemExit(0 if ok else 1)


if __name__ == "__main__":
    main()
