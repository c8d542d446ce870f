"""Per-node metadata registry (reference: MetadataManager.java).

A copy of ``rapid_tpu/protocol/metadata.py`` for the port, held to it by
``tests/test_torch_protocol.py``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

from rapid_tpu_torch.types import Endpoint

FrozenMetadata = Tuple[Tuple[str, bytes], ...]


class MetadataManager:
    def __init__(self) -> None:
        self._table: Dict[Endpoint, FrozenMetadata] = {}

    def get(self, node: Endpoint) -> FrozenMetadata:
        return self._table.get(node, ())

    def add_metadata(self, roles: Mapping[Endpoint, FrozenMetadata]) -> None:
        """put-if-absent, like MetadataManager.java:49."""
        for node, metadata in roles.items():
            self._table.setdefault(node, metadata)

    def remove_node(self, node: Endpoint) -> None:
        self._table.pop(node, None)

    def get_all_metadata(self) -> Dict[Endpoint, FrozenMetadata]:
        return dict(self._table)
