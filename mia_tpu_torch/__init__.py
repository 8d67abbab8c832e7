from .utils.hostmem import tune_malloc as _tune_malloc

_tune_malloc()  # see utils/hostmem.py: page-fault cost dominates the host phases
