"""The LM stack's models (the port of ``repro.models``): config, layers,
MoE, Mamba2/SSD and the model, on torch tensors."""
