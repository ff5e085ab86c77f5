"""CLI entry points (reference argv contracts).

Importing the apps package enables JAX's persistent compilation cache
(utils/compile_cache.py): the production sweeps (run_all_RE.sh
semantics) run one process per case, and the fine-mesh Newton programs
cost minutes to compile — cached, repeat cases start hot.  Library
users importing the core packages directly are not affected.
"""

from ..utils.compile_cache import enable_compile_cache

enable_compile_cache()
