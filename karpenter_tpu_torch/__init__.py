"""karpenter_tpu_torch: the PyTorch/CUDA port of karpenter_tpu.

A Karpenter-style provisioning solve whose dense bucket -> instance-type
cost choice runs as a hand-written CUDA kernel on an NVIDIA H100. The
package mirrors karpenter_tpu's layout and imports nothing of it.
"""
