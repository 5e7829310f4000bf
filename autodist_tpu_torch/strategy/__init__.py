"""Strategy builders: :class:`AllReduce`, :class:`PS` and the default
:class:`PSLoadBalancing`.  The JAX package's other builders are later
slices of the port."""
from autodist_tpu_torch.strategy.all_reduce_strategy import AllReduce
from autodist_tpu_torch.strategy.base import Strategy, StrategyBuilder, StrategyCompiler
from autodist_tpu_torch.strategy.ps_lb_strategy import PSLoadBalancing
from autodist_tpu_torch.strategy.ps_strategy import PS

__all__ = ["AllReduce", "PS", "PSLoadBalancing", "Strategy", "StrategyBuilder",
           "StrategyCompiler"]
