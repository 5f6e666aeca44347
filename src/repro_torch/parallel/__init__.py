"""Sharding: logical-axis rules and the activation-sharding context
(counterpart of ``repro/parallel``)."""
