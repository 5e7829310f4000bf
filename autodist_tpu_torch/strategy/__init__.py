"""Strategy builders: :class:`AllReduce`, the PS family (:class:`PS`, the
default :class:`PSLoadBalancing`, :class:`PartitionedPS`,
:class:`UnevenPartitionedPS`), the partitioned AllReduce family
(:class:`PartitionedAR`, :class:`RandomAxisPartitionAR`) and the hybrid
:class:`Parallax`.  The JAX package's other builders are later slices of
the port."""
from autodist_tpu_torch.strategy.all_reduce_strategy import AllReduce
from autodist_tpu_torch.strategy.base import Strategy, StrategyBuilder, StrategyCompiler
from autodist_tpu_torch.strategy.parallax_strategy import Parallax
from autodist_tpu_torch.strategy.partitioned_all_reduce_strategy import PartitionedAR
from autodist_tpu_torch.strategy.partitioned_ps_strategy import PartitionedPS
from autodist_tpu_torch.strategy.ps_lb_strategy import PSLoadBalancing
from autodist_tpu_torch.strategy.ps_strategy import PS
from autodist_tpu_torch.strategy.random_axis_partition_all_reduce_strategy import (
    RandomAxisPartitionAR)
from autodist_tpu_torch.strategy.uneven_partition_ps_strategy import UnevenPartitionedPS

__all__ = ["AllReduce", "PS", "PSLoadBalancing", "Parallax", "PartitionedAR",
           "PartitionedPS", "RandomAxisPartitionAR", "Strategy", "StrategyBuilder",
           "StrategyCompiler", "UnevenPartitionedPS"]
