"""The LM side of the port: the dense attention family, prefill and
decode (each module's reference is its namesake in :mod:`repro.models`)."""
