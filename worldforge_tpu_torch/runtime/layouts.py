"""Compiler-chosen weight layouts: the JAX package's names, with torch's
answer.

Counterpart of ``worldforge_tpu/runtime/layouts.py``. There, XLA may want
the quantized weight stacks in another on-chip layout than the row-major
one they arrive in, and with default entry layouts it inserts a copy of
each (about 5 GB for the Wan-14B int4 stacks); compiling with AUTO entry
layouts and relaying the weights once removes the copies. A torch tensor
has one layout, the one it was made in, and nothing compiles the loop
around it, so there is nothing to choose: ``auto_layouts_supported()`` is
False and every function hands its arguments back as they are, with no
copy. ``auto_layout=True`` on a pipeline then runs the fused runner on the
weights as they are, the path the JAX package takes where its layout API
is missing.
"""

from __future__ import annotations

from typing import Sequence, Tuple


def auto_layouts_supported() -> bool:
    return False


def jit_matching_layouts(fn, args: Tuple, argnums: Sequence[int] = (0,)):
    """``fn`` itself: the arguments' layouts are the only ones."""
    return fn


def relayout_arg(arg, fmt_tree, donate_old: bool = True):
    """``arg`` itself: there is no other layout to copy it into."""
    return arg


def compile_auto_layouts(fn, args: Tuple, auto_argnums: Sequence[int] = (0,),
                         donate_old: bool = True,
                         donate_argnums: Sequence[int] = None):
    """``(fn, args)``, as the JAX package returns without a layout API."""
    return fn, args
