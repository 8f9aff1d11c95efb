"""The paper's own MLP configurations (section IV-A, Tables I/II); the
same as ``repro/configs/paper_mlp.py``.

The datasets are the procedural stand-ins of ``repro_torch.data``
(``synthetic_mnist``, ``synthetic_features``) with the same feature and
class geometry as the paper's.
"""
from __future__ import annotations

from typing import Tuple

from ..nn.mlp import MLPConfig

# N_net configurations exactly as used in the paper
MNIST_2J = (800, 100, 10)                 # Fig. 1(a-c), Table I
MNIST_4J = (800, 100, 100, 100, 10)       # Fig. 1(d-h), Table II
REUTERS = (2000, 50, 50)                  # Table II
TIMIT = (39, 390, 39)                     # Table II
CIFAR_MLP = (4000, 500, 100)              # Table II (MLP after the CNN)

# Table II rows: (d_out per junction, z per junction)
TABLE2_MNIST = [
    ((80, 80, 80, 10), (200, 25, 25, 4)),
    ((60, 60, 60, 10), (200, 25, 25, 4)),
    ((40, 40, 40, 10), (200, 25, 25, 5)),
    ((20, 20, 20, 10), (200, 25, 25, 10)),
    ((10, 10, 10, 10), (200, 25, 25, 25)),
    ((5, 10, 10, 10), (100, 25, 25, 25)),
    ((2, 5, 5, 10), (80, 25, 25, 50)),
    ((1, 2, 2, 10), (80, 20, 20, 100)),
]


def rho_from_dout(n_net: Tuple[int, ...],
                  d_out: Tuple[int, ...]) -> Tuple[float, ...]:
    """Per-junction densities from out-degrees: rho_i = d_out_i / N_i."""
    return tuple(d / n_net[i + 1] for i, d in enumerate(d_out))


def table1_sparse() -> MLPConfig:
    """Table I sparse column: N=(800,100,10), d_out=(20,10) -> rho=21%."""
    return MLPConfig(n_net=MNIST_2J,
                     rho=rho_from_dout(MNIST_2J, (20, 10)),
                     method="clashfree")


def table1_fc() -> MLPConfig:
    return MLPConfig(n_net=MNIST_2J, rho=None)
