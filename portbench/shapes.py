"""What the yardstick knows of a model's work: its products' shapes and the
bytes and operations its attention or recurrent state add, from the
configuration file alone."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Shapes:
    n_layer: int
    layer_matrices: list  # [(n, k, fmt)] of one layer
    head_matrices: list  # [(n, k, fmt)] outside the layers (the output head)
    kv_bytes_per_position: int = 0  # K and V of one cached position, every layer
    attn_ops_per_position: int = 0  # 4 * D * heads * layers a (query, key) pair
    state_bytes_per_row: int = 0  # a recurrent model's state of one row

    def every_matrix(self) -> list:
        return self.layer_matrices * self.n_layer + self.head_matrices

    def weights(self) -> int:
        return sum(n * k for n, k, _ in self.every_matrix())
