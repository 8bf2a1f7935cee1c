"""Layer shapes of a configuration, read from its file alone.

Everything the yardstick counts comes from here: the variables in the
port's ``.npz`` key space (JAX layouts: HWIO conv kernels, (in, out)
Dense kernels), each with the distribution it is drawn from, and each
conv's and Dense's shape, from which ``work.py`` counts the operations.
The configuration's ``family`` names the module that lays them out
(``families/<family>.py``); nothing here reads the program's modules,
so a later change to the program cannot change what the benchmark
counts.
"""

from __future__ import annotations

from dataclasses import dataclass

from port_bench.families import family


@dataclass(frozen=True)
class Layer:
    """A conv or Dense: its kernel's key and its shape at one image."""

    key: str             # the kernel's key, ".../kernel"
    kind: str            # "conv" or "dense"
    cin: int
    cout: int
    k: int = 1           # kernel size (convs)
    stride: int = 1
    h_in: int = 1
    h_out: int = 1       # square maps: width equals height

    @property
    def macs(self) -> int:
        """Multiply-adds for one image."""
        return self.h_out * self.h_out * self.k * self.k * self.cin * self.cout


@dataclass(frozen=True)
class Leaf:
    """One variable: key, JAX-layout shape and how it is drawn: ``a * z``
    for ``dist`` "normal" (z standard normal), ``a + (b - a) * u`` for
    "uniform" (u uniform on [0, 1))."""

    key: str
    shape: tuple
    dist: str
    a: float
    b: float = 0.0


# The distributions keep a random net's activations in range through
# 50-100 layers: kernels at He scale, a residual branch's last
# BatchNorm scaled by U(0.2, 0.5) (a trained net's branches are small
# against the identity), and non-trivial BatchNorm statistics.
def bn_leaves(prefix: str, c: int, branch_end: bool = False) -> list[Leaf]:
    """A BatchNorm's four leaves; ``prefix`` is its path under params/."""
    lo, hi = (0.2, 0.5) if branch_end else (0.8, 1.2)
    return [Leaf(f"params/{prefix}/scale", (c,), "uniform", lo, hi),
            Leaf(f"params/{prefix}/bias", (c,), "normal", 0.1),
            Leaf(f"batch_stats/{prefix}/mean", (c,), "normal", 0.2),
            Leaf(f"batch_stats/{prefix}/var", (c,), "uniform", 0.5, 2.0)]


def conv_leaf(layer: Layer) -> Leaf:
    fan_in = layer.k * layer.k * layer.cin
    return Leaf(layer.key, (layer.k, layer.k, layer.cin, layer.cout),
                "normal", (2.0 / fan_in) ** 0.5)


def dense_leaves(layer: Layer) -> list[Leaf]:
    base = layer.key.rsplit("/", 1)[0]
    return [Leaf(layer.key, (layer.cin, layer.cout), "normal",
                 (1.0 / layer.cin) ** 0.5),
            Leaf(f"{base}/bias", (layer.cout,), "normal", 0.1)]


def alpha_leaf(prefix: str, c: int) -> Leaf:
    """A PReLU's slopes."""
    return Leaf(f"params/{prefix}/alpha", (c,), "uniform", 0.1, 0.3)


def out_size(size: int, stride: int) -> int:
    return -(-size // stride)


def layers_of(cfg: dict) -> tuple[list[Layer], list[Leaf]]:
    """(convs and Denses, variables) of a configuration."""
    return family(cfg["family"]).layers(cfg)
