"""Network families, one module each, found by the ``family`` key of a
configuration's file: ``families/<family>.py``.

A family module holds what the benchmark knows of one kind of network,
read from a configuration's sizes alone:

- ``layers(cfg) -> (layers, leaves)``: every conv and Dense with its
  shape at one image (``arch.Layer``), from which ``work.py`` counts the
  operations, and every variable in the port's ``.npz`` key space with
  the distribution it is drawn from (``arch.Leaf``);
- ``forward(v, x, cfg, quant=None)``: the plain f32 reference of the
  eval forward pass, built from ``reference.layers`` (it imports nothing
  of the program, of JAX or of the JAX package);
- ``program_kwargs(cfg)``: the configuration's sizes as the fields that
  the program's ``models.create_network`` takes;
- ``TINY``: the sizes a CPU test shrinks the configuration to.

A later configuration of another kind of network adds its family as a
new file here; no file that is there changes.
"""

from __future__ import annotations

import importlib


def family(name: str):
    """The module of the family ``name``."""
    return importlib.import_module(f"port_bench.families.{name}")
