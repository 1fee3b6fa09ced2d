"""NOAA USCRN wind-dataset builder (a copy of :mod:`volt_tpu.data.wind`).

Reference ``experiments/weather/make_wind_dataset.ipynb``: scrape the
sub-hourly 2021 USCRN archive, keep stations with complete records
(105120 rows), take column 21 (wind speed), map the ``-99.0`` sentinel to
0, and pickle ``(names, lonlat, data)``.  Network access is gated exactly
like the other ingestion edges (its packages imported inside); the parsing
logic is importable and unit-testable without it.
"""

from __future__ import annotations

import pickle

import numpy as np

__all__ = ["parse_uscrn_rows", "build_wind_dataset",
           "build_wind_dataset_from_files", "USCRN_BASE_URL"]

USCRN_BASE_URL = (
    "https://www.ncei.noaa.gov/pub/data/uscrn/products/subhourly01/2021/"
)
_EXPECTED_ROWS = 105_120  # 365 days * 288 five-minute rows
_WIND_COL = 21
# USCRN subhourly whitespace tokens: 6 = LONGITUDE, 7 = LATITUDE
# (notebook ``dat.iloc[0, 6] / iloc[0, 7]``; tokens 3/4 are
# LST_DATE/LST_TIME — reading those made the CONUS lon filter a no-op)
_LON_COL, _LAT_COL = 6, 7


def parse_uscrn_rows(lines, expected_rows: int | None = None):
    """Parse one station's raw text rows -> ``(lonlat, wind)`` or ``None``
    if the record is incomplete (the notebook's completeness filter).

    ``expected_rows`` defaults to the full-year sub-hourly count (105120);
    the vendored offline fixtures pass their truncated length so the same
    filter logic runs without a 10 MB file in the tree."""
    if expected_rows is None:
        expected_rows = _EXPECTED_ROWS
    rows = [line.split() for line in lines if line.strip()]
    if len(rows) != expected_rows:
        return None
    lonlat = (float(rows[0][_LON_COL]), float(rows[0][_LAT_COL]))
    wind = np.array([float(r[_WIND_COL]) for r in rows], np.float32)
    wind[wind == -99.0] = 0.0
    return lonlat, wind


def _assemble(station_texts, year: int, expected_rows: int | None):
    """``[(fname, text), ...]`` -> ``(names, lonlat, data)`` with the
    notebook's completeness filter and name slice applied."""
    names, lonlats, data = {}, [], []
    for fname, txt in station_texts:
        parsed = parse_uscrn_rows(txt.splitlines(), expected_rows)
        if parsed is None:
            continue
        lonlat, wind = parsed
        # notebook name slice url[17:-4]: strips "CRNS0101-05-YYYY-",
        # yielding e.g. "AK_Cordova_14_ESE" (year prefix removed too)
        names[len(data)] = fname.replace(
            f"CRNS0101-05-{year}-", ""
        ).replace(".txt", "")
        lonlats.append(lonlat)
        data.append(wind)
    return names, np.array(lonlats), data


def build_wind_dataset_from_files(files, out_path: str | None = None,
                                  year: int = 2021,
                                  expected_rows: int | None = None):
    """Offline twin of :func:`build_wind_dataset`: same completeness
    filter, sentinel mapping, name slice, and pickle layout, over local
    USCRN station files (e.g. the vendored ``data/fixtures`` sample) —
    the ingestion path is executable with zero network access."""
    import os

    texts = []
    for path in files:
        with open(path) as fh:
            texts.append((os.path.basename(path), fh.read()))
    names, lonlat, data = _assemble(texts, year, expected_rows)
    if out_path is not None:
        with open(out_path, "wb") as fh:
            pickle.dump((names, lonlat, data), fh)
    return names, lonlat, data


def build_wind_dataset(out_path: str = "wind_data.p", year: int = 2021,
                       limit: int | None = None):
    """Scrape + pickle the USCRN wind dataset (requires network access)."""
    try:
        import requests
        from bs4 import BeautifulSoup
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "requests/beautifulsoup4 are not installed; the wind scrape is "
            "an optional data edge (reference make_wind_dataset.ipynb)"
        ) from e

    base = USCRN_BASE_URL.replace("2021", str(year))
    index = requests.get(base, timeout=60)
    soup = BeautifulSoup(index.text, "html.parser")
    files = [a["href"] for a in soup.find_all("a")
             if a.get("href", "").endswith(".txt")]
    if limit is not None:  # limit=0 means "scrape nothing", not "all"
        files = files[:limit]

    station_texts = (
        (fname, requests.get(base + fname, timeout=120).text)
        for fname in files
    )
    names, lonlat, data = _assemble(station_texts, year, None)
    with open(out_path, "wb") as fh:
        pickle.dump((names, lonlat, data), fh)
    return names, lonlat, data
