"""repro_torch.analysis — the dry-run's analysis: the analytic memory model
(``memory``), the roofline terms with the H100's constants (``roofline``),
the counts of one rank's work in a traced step (``trace``: torch's
``FlopCounterMode``, ``CommDebugMode`` and ``MemTracker``, in the roles of
the reference's HLO walk and ``memory_analysis()``) and the tables of the
JSON cache (``report``).

The reference's ``hlo_walk`` parses XLA's HLO, which torch does not have:
``trace`` takes its role.  ``simlint`` checks the reference's structural
invariants of the engine (R1-R6) on recorded operator traces, gates and
launch plans instead of jaxprs and HLO (CLI: ``scripts/simlint_torch.py``).
"""
from repro_torch.analysis import memory, roofline, simlint, trace

# report is a script too (python -m repro_torch.analysis.report): importing
# it here would load it twice under -m
__all__ = ["memory", "report", "roofline", "simlint", "trace"]
