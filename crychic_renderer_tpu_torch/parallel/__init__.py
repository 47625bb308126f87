"""Band-sharded frames over torch.distributed (``sharded``) and the
launcher that starts their ranks on one host (``launch``)."""
