"""Small filesystem helpers (counterpart of ``uspace_tpu/utils/misc.py``).

The dissection workflow's dump-directory cleanup: strip a stage prefix like
``tail_`` off every file in a feature directory so downstream loaders see
plain names. Only the leading occurrence of the prefix is stripped (the
reference's ``str.replace`` would also delete interior occurrences).
"""

from __future__ import annotations

import glob
import os
from typing import List


def strip_prefix_in_dir(path: str, prefix: str = "tail_") -> List[str]:
    """Rename every ``<prefix><name>`` file in ``path`` to ``<name>``.

    Returns the new paths of the renamed files. Refuses to overwrite an
    existing target (raises ``FileExistsError``) rather than silently
    clobbering a previous dump.
    """
    renamed = []
    for f in sorted(glob.glob(os.path.join(path, "*"))):
        base = os.path.basename(f)
        if not base.startswith(prefix) or base == prefix:
            continue
        target = os.path.join(path, base[len(prefix):])
        if os.path.exists(target):
            raise FileExistsError(target)
        os.rename(f, target)
        renamed.append(target)
    return renamed
