"""The keys of a configuration file that OpenAI's ViT layout fixes, with
OpenAI's values as their defaults (the schema: ``harness.py``'s
docstring). Every reader of a configuration takes them from here, so a
file that leaves them out reads as OpenAI's layout everywhere."""

from __future__ import annotations

#: the MLP activations a configuration may state: OpenAI's
#: ``x * sigmoid(1.702 x)`` and the exact (erf) GELU
ACTIVATIONS = ("quick_gelu", "gelu")
#: the two transformer towers, by the prefix of their keys
TOWERS = ("vision", "transformer")


def mlp_width(cfg: dict, tower: str) -> int:
    """The hidden width of ``tower``'s MLP: ``<tower>_mlp_width``, else
    four times the tower's width."""
    return cfg.get(f"{tower}_mlp_width", 4 * cfg[f"{tower}_width"])


def head_width(cfg: dict, tower: str) -> int:
    """``<tower>_width`` over ``<tower>_heads``, which has to divide it."""
    width, heads = cfg[f"{tower}_width"], cfg[f"{tower}_heads"]
    if width % heads:
        raise ValueError(f"{tower}_width {width} is not a whole number of "
                         f"{tower}_heads {heads}")
    return width // heads


def activation(cfg: dict) -> str:
    """The MLP's activation: ``activation``, else ``"quick_gelu"``."""
    act = cfg.get("activation", "quick_gelu")
    if act not in ACTIVATIONS:
        raise ValueError(f"activation {act!r}; known: {ACTIVATIONS}")
    return act
