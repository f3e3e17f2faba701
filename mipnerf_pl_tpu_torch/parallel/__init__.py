"""The (data, model) mesh and the Megatron parameter shardings."""
