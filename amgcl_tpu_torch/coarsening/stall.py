"""The coarsening-stall exception (counterpart of
``amgcl_tpu/coarsening/stall.py``).

A stall — no coarse points can be produced for a level — is an EXPECTED
terminal condition: the hierarchy builder catches exactly this class and
closes the hierarchy with the levels it has (the reference reaches the
analogous state via error::empty_level, amgcl/amg.hpp). Every other
ValueError from a coarsening policy is a real error and propagates."""


class CoarseningStall(ValueError):
    """A level cannot coarsen further; close the hierarchy here."""
