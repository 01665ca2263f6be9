"""Architecture configs of the model zoo that the port serves (copies of
``repro/configs``'s dense LM, Wide&Deep and GCN specs)."""
