"""Plants literal edits in a copy of the checkout, never in the checkout
itself: the probes build and run such copies to time a variant of a kernel
or to show that a planted fault is caught.

    python3 probes/plant.py DEST [FILE OLD NEW]...

copies ``src/`` (without built libraries or caches) and ``chip_smoke.py``
into DEST, then in each FILE (a path relative to the checkout) replaces
OLD by NEW.  Each OLD must occur in its file exactly once; otherwise it
exits 1 and names the edit.
"""
from __future__ import annotations

import os
import shutil
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def plant(dest: str, edits=(), extra=(), root: str = REPO) -> None:
    """Copy ``src/``, ``chip_smoke.py`` and the ``extra`` files (paths
    relative to the checkout) from the checkout ``root`` into ``dest``,
    then apply ``edits``, each a (path, old, new) triple of literal text."""
    shutil.copytree(os.path.join(root, "src"), os.path.join(dest, "src"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for name in ("chip_smoke.py", *extra):
        os.makedirs(os.path.dirname(os.path.join(dest, name)), exist_ok=True)
        shutil.copy(os.path.join(root, name), os.path.join(dest, name))
    for path, old, new in edits:
        full = os.path.join(dest, path)
        with open(full) as f:
            text = f.read()
        if text.count(old) != 1:
            raise SystemExit(f"plant: {path}: {old[:70]!r} occurs "
                             f"{text.count(old)} times, not once")
        with open(full, "w") as f:
            f.write(text.replace(old, new))


def main(argv: list) -> int:
    if not argv or (len(argv) - 1) % 3:
        raise SystemExit(__doc__)
    dest, rest = argv[0], argv[1:]
    plant(dest, zip(rest[0::3], rest[1::3], rest[2::3]))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
