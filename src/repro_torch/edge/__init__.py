"""Edge and cloud servers, the rebalance data-plane, and
:class:`~repro_torch.edge.system.EdgeCloudSystem`, the paper's pipeline."""
