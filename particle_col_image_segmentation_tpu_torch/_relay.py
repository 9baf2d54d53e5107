"""The JAX package's relay workarounds, which the port does not carry.

The JAX package packs label planes into nibbles, places batches with a
``sharding``, and pads or packs transfers, to save bytes on a TPU host link
(its ``packed=``, ``sharding=``, ``pack_transfer=``, ``pack=`` and
``pad_to_full=`` arguments).  The port drops that TPU-only scaffolding: a
call that passes such an argument at its default binds as it does in the
JAX package, and any other value is refused here, never ignored.
"""

from __future__ import annotations

__all__ = ["refuse_relay_arg"]


def refuse_relay_arg(fn: str, name: str, value, default) -> None:
    """Raise unless ``value`` is ``default`` (or a bool equal to it)."""
    if value is default or (isinstance(value, bool) and value == default):
        return
    raise ValueError(
        f"{fn}: {name}={value!r} is not supported: the PyTorch port drops the JAX "
        f"package's relay workarounds (packed transfers, shardings, nibble packing) "
        f"by its north-star rule; pass {name}={default!r} or leave it out"
    )
