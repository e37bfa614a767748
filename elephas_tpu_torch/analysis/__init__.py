"""Static-analysis subsystem over the port's tree (counterpart of
``elephas_tpu/analysis``): a rule registry over a parse-once repo view.

The eight lint domains of ``analysis/legacy.py`` plus the concurrency
analyzers (``lock-order``, ``lock-blocking``) and the ``dead-pragma``
audit. Run with ``python -m elephas_tpu_torch.analysis``; see
``--list-rules``. ``--write ANALYSIS_TORCH.json`` refreshes the committed
report, whose lock graph seeds the runtime sanitizer
(``utils/locksan.py``).
"""

from elephas_tpu_torch.analysis.core import (PRAGMAS, Finding, Repo, Rule,
                                             SourceFile, suppressions,
                                             violations)
from elephas_tpu_torch.analysis.cli import (build_report, build_rules,
                                            main, run_rules)
from elephas_tpu_torch.analysis.locks import (BlockingUnderLockRule,
                                              LockAnalysis, LockOrderRule,
                                              get_analysis)
from elephas_tpu_torch.analysis.pragmas import DeadPragmaRule

__all__ = [
    "PRAGMAS", "Finding", "Repo", "Rule", "SourceFile",
    "suppressions", "violations",
    "build_report", "build_rules", "main", "run_rules",
    "BlockingUnderLockRule", "LockAnalysis", "LockOrderRule",
    "get_analysis", "DeadPragmaRule",
]
