"""Dependency-free `.env` support for the data stage.

The port's own copy of `pivp_tpu/utils/dotenv.py`. The reference loads
`.env` through python-dotenv before its ETL runs (make_dataset.py:7,173;
the cookiecutter layout keeps S3 credentials there). That package is not
a dependency, so this is a minimal reimplementation of the two calls the
reference makes: `find_dotenv()` (walk up from the working directory)
and `load_dotenv(path)` (KEY=VALUE lines into os.environ, existing
variables win).
"""

from __future__ import annotations

import os
from typing import Optional


def find_dotenv(filename: str = ".env",
                start: Optional[str] = None) -> str:
    """Path of the nearest `filename` walking up from `start` (default:
    the working directory); '' if none found — mirroring
    dotenv.find_dotenv's no-raise default."""
    d = os.path.abspath(start or os.getcwd())
    while True:
        candidate = os.path.join(d, filename)
        if os.path.isfile(candidate):
            return candidate
        parent = os.path.dirname(d)
        if parent == d:
            return ""
        d = parent


def load_dotenv(path: str = "", override: bool = False) -> bool:
    """Parse KEY=VALUE lines (comments/blank lines skipped, optional
    `export ` prefix, single/double quotes stripped) into os.environ.
    Returns True if a file was loaded. Existing environment variables
    win unless `override` (python-dotenv's default)."""
    path = path or find_dotenv()
    if not path or not os.path.isfile(path):
        return False
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            if line.startswith("export "):
                line = line[len("export "):]
            key, _, value = line.partition("=")
            key = key.strip()
            value = value.strip()
            if len(value) >= 2 and value[0] == value[-1] and \
                    value[0] in ("'", '"'):
                value = value[1:-1]
            if key and (override or key not in os.environ):
                os.environ[key] = value
    return True
