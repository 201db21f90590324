"""Post-hoc steps after training: ensembling, postprocessing, the choice of the best configuration and model sharing (numpy only)."""
