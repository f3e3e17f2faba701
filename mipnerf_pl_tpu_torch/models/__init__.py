"""The MLP and the MipNerf model as torch modules."""
