"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version:

  conv_block.conv_block_fwd        kernel 1, the fused ConvBlock forward
  conv_block.conv_block_fwd_dual   kernel 2, the same on [xa | xb]
  mc_consensus.mc_consensus        kernel 3, MC Fcomb tail + consensus
  conv_block.conv_block_bwd        the fused ConvBlock backward (kernel 1's
                                   autograd backward; dx optional)
  conv_block.conv_block_bwd_dual   the same for [xa | xb] (kernel 2's)

A wrapper runs the plain version on a CPU tensor and the kernel on a CUDA
tensor (the plain version there too under ``conv_block.plain_versions()``);
``<wrapper>.launches`` counts kernel launches. The kernels build on
first use (``_build``)."""
