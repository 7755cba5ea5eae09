"""Default configuration tree of the port.

The same keys, types and defaults as the JAX package's configuration (the
reference's yacs schema plus the `tpu` block of renderer capacities and
switches), so the repo's YAML files and dotted overrides drive both packages
unchanged. The `tpu` block keeps its name for that reason; the port reads the
renderer switches from it and rejects values whose paths it has not ported
(render/demo.py).
"""

from gpnerf_tpu_torch.config.yacs_compat import CfgNode as CN


cfg = CN()

cfg.device = "tpu"

cfg.dist_backend = "jax"

cfg.log_dir = "logs/"
cfg.output_dir = "outputs/"
cfg.result_dir = "results/"

cfg.seed = 42

cfg.workers = 4

cfg.pi = "psnr"
cfg.cam_num = -1
cfg.fix_human = False
cfg.fix_pose = False
cfg.mask_bkgd = True
cfg.src_view_num = 3
cfg.num_frame = 200
cfg.xyz_res = 10
cfg.view_res = 4

cfg.dataset = CN()

cfg.dataset.img_num_per_gpu = 1

cfg.dataset.H = 1024
cfg.dataset.W = 1024
cfg.dataset.ratio = 0.5
cfg.dataset.voxel_size = [0.005, 0.005, 0.005]

cfg.dataset.train = CN()
cfg.dataset.train.name = "thuman"
cfg.dataset.train.data_root = "data/thuman/"
cfg.dataset.train.file = "CustomDataset"
cfg.dataset.train.dataset_cams = 24
cfg.dataset.train.sampler = ""
cfg.dataset.train.batch_sampler = "default"
cfg.dataset.train.sampler_meta = CN(
    {"min_hw": [256, 256], "max_hw": [480, 640], "strategy": "range"}
)
cfg.dataset.train.drop_last = True
cfg.dataset.train.shuffle = True
cfg.dataset.train.seq_list = []
cfg.dataset.train.interval = 1
cfg.dataset.train.chunk = 400

cfg.dataset.test = CN()
cfg.dataset.test.name = "zju_mocap"
cfg.dataset.test.data_root = "data/zju_mocap/"
cfg.dataset.test.file = "ZjumocapDataset"
cfg.dataset.test.dataset_cams = 24
cfg.dataset.test.sampler = ""
cfg.dataset.test.batch_sampler = "default"
cfg.dataset.test.sampler_meta = CN(
    {"min_hw": [480, 640], "max_hw": [480, 640], "strategy": "origin"}
)
cfg.dataset.test.drop_last = False
cfg.dataset.test.shuffle = False
cfg.dataset.test.seq_list = ["CoreView_315"]
cfg.dataset.test.interval = 7
cfg.dataset.test.chunk = 2000

cfg.render = CN()
cfg.render.file = "BaseRender"
cfg.render.resume_path = ""

cfg.encoder = CN()
cfg.encoder.name = "resnet34"
cfg.encoder.file = "UNet"
cfg.encoder.out_ch = 32

cfg.head = CN()
cfg.head.file = "BaseNeRFHead"
cfg.head.rgb = CN()
cfg.head.rgb.use_rgbhead = True
cfg.head.sigma = CN()
cfg.head.sigma.code_dim = 16
cfg.head.sigma.n_heads = 4
cfg.head.sigma.n_layers = 4
cfg.head.sigma.n_smpl = 6890
cfg.head.sigma.outdims = [32, 32, 32, 32]

cfg.train = CN()

cfg.train.file = "BaseTrainer"
cfg.train.criterion_file = "BaseNeRFCriterion"

cfg.train.resume = False

cfg.train.body_sample_ratio = 0.5
cfg.train.n_rays = 1024
cfg.train.n_samples = 64

cfg.train.ep_iter = 500
cfg.train.lr = 1e-4
cfg.train.gamma = 0.1
cfg.train.decay_epochs = 1000
cfg.train.weight_decay = 0.0001
cfg.train.max_epoch = 1000

cfg.train.print_freq = 10
cfg.train.save_every_checkpoint = True
cfg.train.save_interval = 1
cfg.train.valiter_interval = 100
cfg.train.val_when_train = False

cfg.test = CN()

cfg.test.save_imgs = True
cfg.test.test_seq = "CoreView_315"
cfg.test.is_vis = False
cfg.test.mesh_th = 50
cfg.test.profile = False

cfg.tpu = CN()
cfg.tpu.site_cap = 8192
cfg.tpu.level_caps = [20480, 10240, 4096, 2048]
cfg.tpu.max_out_sh = [96, 384, 384]
cfg.tpu.ray_cap = 32768
cfg.tpu.sigma_cap = 319488
cfg.tpu.rgb_cap = 196608
cfg.tpu.samples_per_ray = 13
cfg.tpu.tight_cull = True
cfg.tpu.splat_cap = 393216
cfg.tpu.tap_window = 32
cfg.tpu.eval_ray_cap = 131072
cfg.tpu.eval_chunk = 8192
cfg.tpu.quantize_volume = True
cfg.tpu.pack_octet_u32 = False
cfg.tpu.proj_vp_order = False
cfg.tpu.pallas_lerp = True
cfg.tpu.pallas_point = True
cfg.tpu.kernel_octet = True
cfg.tpu.quantize_proj = True
cfg.tpu.dense_conv = False
cfg.tpu.frame_mode = False
cfg.tpu.dense_slots = True
cfg.tpu.window_margin_voxels = 6.0
cfg.tpu.splat_bins = True
cfg.tpu.bin_margin_voxels = 2.0
cfg.tpu.merge_src_feat = False
cfg.tpu.merge_lowres_src = False
cfg.tpu.merge_coarse_octet = True
cfg.tpu.fold_coarse_fc = True
cfg.tpu.int4_coarse = False
cfg.tpu.int4_feat = False
cfg.tpu.coarse_nearest = 2
cfg.tpu.l1_nearest = 0
cfg.tpu.sigma_query_cull = False
cfg.tpu.base_occupancy_cull = False
cfg.tpu.matmul_dtype = "bfloat16"
cfg.tpu.train_dtype = "float32"
cfg.tpu.dp_axis = "dp"
cfg.tpu.dp_size = -1

def update_config(config, args):
    config.defrost()
    config.merge_from_file(args.yaml_file)
    config.merge_from_list(args.opts)
    config.freeze()
