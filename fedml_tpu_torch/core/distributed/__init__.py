"""The port's ``core/distributed``: only the topology managers so far
(ROADMAP.md queue A, item 9a: transport and cross-silo FedAvg)."""
