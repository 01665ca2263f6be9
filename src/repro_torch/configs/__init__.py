"""Architecture configs of the model zoo that the port serves (copies of
``repro/configs``'s dense and MoE LM, Wide&Deep and GNN specs: GCN, PNA,
EGNN and NequIP)."""
