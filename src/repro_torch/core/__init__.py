"""The port's numeric core: moduli, scaling, plans, the executor and the
policy (counterparts of `repro.core` modules of the same names)."""
