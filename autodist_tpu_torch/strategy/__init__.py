"""Strategy builders.  This slice carries :class:`AllReduce`; the other
builders of the JAX package are later slices of the port."""
from autodist_tpu_torch.strategy.all_reduce_strategy import AllReduce
from autodist_tpu_torch.strategy.base import Strategy, StrategyBuilder, StrategyCompiler


class PSLoadBalancing(StrategyBuilder):
    """The JAX package's default builder; its PS realisation (reduce-scatter,
    shard update, all-gather) is a later slice of the port."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "PSLoadBalancing is a later slice of the port (ROADMAP, Queue A "
            "item 2: the PS realisation); pass strategy_builder=AllReduce()")

    def build(self, model_item, resource_spec):
        raise NotImplementedError


__all__ = ["AllReduce", "PSLoadBalancing", "Strategy", "StrategyBuilder",
           "StrategyCompiler"]
