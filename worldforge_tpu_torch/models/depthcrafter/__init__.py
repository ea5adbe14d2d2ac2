"""DepthCrafter: the SVD spatio-temporal UNet, the SVD temporal VAE and depth inference."""
