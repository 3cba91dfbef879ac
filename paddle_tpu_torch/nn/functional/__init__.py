"""paddle_tpu_torch.nn.functional (counterpart of
``paddle_tpu/nn/functional``, with the fluid-era
``adaptive_average_pool*`` spellings)."""
from .activation import (elu, elu_, gelu, glu, gumbel_softmax, hardshrink,
                         hardsigmoid, hardswish, hardtanh, leaky_relu,
                         log_sigmoid, log_softmax, maxout, mish, prelu, relu,
                         relu6, relu_, rrelu, selu, sigmoid, silu, softmax,
                         softmax_, softplus, softshrink, softsign, swish,
                         tanh, tanh_, tanhshrink, thresholded_relu)
from .attention import flash_attention, scaled_dot_product_attention
from .common import (alpha_dropout, bilinear, channel_shuffle,
                     cosine_similarity, dropout, dropout2d, dropout3d,
                     embedding, fold, interpolate, label_smooth, linear,
                     one_hot, pad, pairwise_distance, pixel_shuffle,
                     pixel_unshuffle, unfold, upsample, zeropad2d)
from .conv import (conv1d, conv1d_transpose, conv2d, conv2d_transpose, conv3d,
                   conv3d_transpose)
from .extension import diag_embed, gather_tree, sequence_mask, temporal_shift
from .loss import (binary_cross_entropy, binary_cross_entropy_with_logits,
                   cosine_embedding_loss, cross_entropy, ctc_loss, dice_loss,
                   hinge_embedding_loss, hsigmoid_loss, kl_div, l1_loss,
                   log_loss, margin_ranking_loss, mbce_loss, mse_loss,
                   nll_loss, npair_loss, sigmoid_focal_loss,
                   smooth_l1_loss, softmax_with_cross_entropy,
                   square_error_cost, triplet_margin_loss)
from .norm import (batch_norm, group_norm, instance_norm, layer_norm,
                   local_response_norm, normalize, rms_norm)
from .pooling import (adaptive_avg_pool1d, adaptive_avg_pool2d,
                      adaptive_avg_pool3d, adaptive_max_pool1d,
                      adaptive_max_pool2d, adaptive_max_pool3d, avg_pool1d,
                      avg_pool2d, avg_pool3d, max_pool1d, max_pool2d,
                      max_pool3d)
from .sequence import (sequence_concat, sequence_conv, sequence_enumerate,
                       sequence_erase, sequence_expand, sequence_expand_as,
                       sequence_first_step, sequence_last_step, sequence_pad,
                       sequence_pool, sequence_reshape, sequence_reverse,
                       sequence_scatter, sequence_slice, sequence_softmax,
                       sequence_unpad)
from .vision import affine_grid, grid_sample

# fluid-era long-form spellings
adaptive_average_pool1d = adaptive_avg_pool1d
adaptive_average_pool2d = adaptive_avg_pool2d
adaptive_average_pool3d = adaptive_avg_pool3d
