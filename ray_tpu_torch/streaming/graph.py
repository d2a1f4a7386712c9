"""Job graph: logical operator DAG -> physical execution graph
(reference: streaming/python/runtime/graph.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

# partition strategies (reference streaming/python/partition.py)
FORWARD = "forward"        # one-to-one when parallelism matches, else rebalance
REBALANCE = "rebalance"    # round-robin
KEY_HASH = "key_hash"      # hash(key) % downstream parallelism
BROADCAST = "broadcast"    # every downstream instance


@dataclass
class Operator:
    op_id: int
    kind: str                  # source/map/flat_map/filter/key_by/reduce/sink
    fn: Optional[Callable]
    parallelism: int = 1
    name: str = ""

    def __post_init__(self):
        if not self.name:
            self.name = f"{self.kind}_{self.op_id}"


@dataclass
class Edge:
    src_id: int
    dst_id: int
    partition: str


@dataclass
class JobGraph:
    operators: Dict[int, Operator] = field(default_factory=dict)
    edges: List[Edge] = field(default_factory=list)

    def add_operator(self, op: Operator) -> None:
        self.operators[op.op_id] = op

    def add_edge(self, src_id: int, dst_id: int, partition: str) -> None:
        self.edges.append(Edge(src_id, dst_id, partition))

    def upstream_of(self, op_id: int) -> List[Edge]:
        return [e for e in self.edges if e.dst_id == op_id]

    def downstream_of(self, op_id: int) -> List[Edge]:
        return [e for e in self.edges if e.src_id == op_id]
