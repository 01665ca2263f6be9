"""AdamW and int8 error-feedback gradient compression (port of
``repro/optim``)."""
