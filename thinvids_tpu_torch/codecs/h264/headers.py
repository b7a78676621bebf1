"""H.264 parameter sets and slice headers (§7.3.2, §7.3.3).

Baseline profile, progressive, 4:2:0, one slice per picture, CAVLC,
pic_order_cnt_type=2 (display order == decode order — true for the
intra/IPPP streams this codec emits), deblocking disabled via the slice
header so encoder reconstruction is exactly what decoders output.
"""

from __future__ import annotations

import dataclasses

from ...io.bits import BitReader, BitWriter, annexb_nal

NAL_SLICE_IDR = 5
NAL_SEI = 6
NAL_SPS = 7
NAL_PPS = 8
NAL_SLICE_NON_IDR = 1

SLICE_TYPE_P = 0
SLICE_TYPE_I = 2


@dataclasses.dataclass(frozen=True)
class SPS:
    width: int                     # luma samples, pre-crop display width
    height: int
    profile_idc: int = 66          # baseline
    level_idc: int = 40
    log2_max_frame_num: int = 8
    num_ref_frames: int = 1
    fps_num: int = 30
    fps_den: int = 1

    def __post_init__(self):
        if self.width % 2 or self.height % 2:
            # 4:2:0 frame cropping offsets are in 2-luma-pixel units, so
            # an odd display dimension cannot be represented — callers
            # must pre-scale to even dimensions. Validated here (not in
            # to_rbsp) so encoders fail fast at construction.
            raise ValueError(
                f"odd dimensions {self.width}x{self.height} are not "
                "representable with 4:2:0 frame cropping")

    @property
    def mb_width(self) -> int:
        return (self.width + 15) // 16

    @property
    def mb_height(self) -> int:
        return (self.height + 15) // 16

    def to_rbsp(self) -> bytes:
        bw = BitWriter()
        bw.write(self.profile_idc, 8)
        # constraint_set0..5 + reserved: set0/set1 for baseline compat
        bw.write(0b11000000, 8)
        bw.write(self.level_idc, 8)
        bw.ue(0)                               # seq_parameter_set_id
        bw.ue(self.log2_max_frame_num - 4)     # log2_max_frame_num_minus4
        bw.ue(2)                               # pic_order_cnt_type
        bw.ue(self.num_ref_frames)             # max_num_ref_frames
        bw.write_bit(0)                        # gaps_in_frame_num_allowed
        bw.ue(self.mb_width - 1)
        bw.ue(self.mb_height - 1)              # map units (frame_mbs_only)
        bw.write_bit(1)                        # frame_mbs_only_flag
        bw.write_bit(1)                        # direct_8x8_inference_flag
        crop_r = (self.mb_width * 16 - self.width) // 2
        crop_b = (self.mb_height * 16 - self.height) // 2
        if crop_r or crop_b:
            bw.write_bit(1)
            bw.ue(0)          # left
            bw.ue(crop_r)     # right (units of SubWidthC=2)
            bw.ue(0)          # top
            bw.ue(crop_b)     # bottom (units of SubHeightC*(2-fmof)=2)
        else:
            bw.write_bit(0)
        # VUI with timing so probes report fps
        bw.write_bit(1)                        # vui_parameters_present
        bw.write_bit(0)                        # aspect_ratio_info_present
        bw.write_bit(0)                        # overscan_info_present
        bw.write_bit(0)                        # video_signal_type_present
        bw.write_bit(0)                        # chroma_loc_info_present
        bw.write_bit(1)                        # timing_info_present
        bw.write(self.fps_den, 32)             # num_units_in_tick
        bw.write(self.fps_num * 2, 32)         # time_scale (field rate)
        bw.write_bit(1)                        # fixed_frame_rate_flag
        bw.write_bit(0)                        # nal_hrd_parameters_present
        bw.write_bit(0)                        # vcl_hrd_parameters_present
        bw.write_bit(0)                        # pic_struct_present
        bw.write_bit(0)                        # bitstream_restriction
        bw.rbsp_trailing_bits()
        return bw.getvalue()

    def to_nal(self) -> bytes:
        return annexb_nal(3, NAL_SPS, self.to_rbsp())

    @classmethod
    def parse_rbsp(cls, rbsp: bytes) -> "SPS":
        br = BitReader(rbsp)
        profile = br.read(8)
        br.read(8)  # constraint flags
        level = br.read(8)
        br.ue()     # sps id
        if profile in (100, 110, 122, 244, 44, 83, 86, 118, 128):
            chroma = br.ue()
            if chroma == 3:
                br.read_bit()
            br.ue()
            br.ue()
            br.read_bit()
            if br.read_bit():  # seq_scaling_matrix_present
                raise ValueError("scaling matrices not supported")
        log2_mfn = br.ue() + 4
        poc_type = br.ue()
        if poc_type == 0:
            br.ue()
        elif poc_type == 1:
            br.read_bit()
            br.se()
            br.se()
            for _ in range(br.ue()):
                br.se()
        num_ref = br.ue()
        br.read_bit()
        mbw = br.ue() + 1
        mbh_units = br.ue() + 1
        fmof = br.read_bit()
        mbh = mbh_units * (1 if fmof else 2)
        if not fmof:
            br.read_bit()  # mb_adaptive_frame_field
        br.read_bit()  # direct_8x8_inference
        width, height = mbw * 16, mbh * 16
        if br.read_bit():  # cropping
            cl, cr, ct, cb = br.ue(), br.ue(), br.ue(), br.ue()
            width -= 2 * (cl + cr)
            height -= (2 if fmof else 4) * (ct + cb)
        fps_num, fps_den = 30, 1
        if br.read_bit():  # vui present
            if br.read_bit():  # aspect ratio
                if br.read(8) == 255:
                    br.read(32)
            if br.read_bit():
                br.read_bit()  # overscan
            if br.read_bit():  # video signal type
                br.read(3)
                br.read_bit()
                if br.read_bit():
                    br.read(24)
            if br.read_bit():  # chroma loc
                br.ue()
                br.ue()
            if br.read_bit():  # timing
                fps_den = br.read(32)
                fps_num = br.read(32) // 2 or 30
        return cls(width=width, height=height, profile_idc=profile,
                   level_idc=level, log2_max_frame_num=log2_mfn,
                   num_ref_frames=num_ref, fps_num=fps_num, fps_den=fps_den)


@dataclasses.dataclass(frozen=True)
class PPS:
    init_qp: int = 26
    deblocking_control_present: bool = True

    def to_rbsp(self) -> bytes:
        bw = BitWriter()
        bw.ue(0)             # pic_parameter_set_id
        bw.ue(0)             # seq_parameter_set_id
        bw.write_bit(0)      # entropy_coding_mode (CAVLC)
        bw.write_bit(0)      # bottom_field_pic_order_in_frame_present
        bw.ue(0)             # num_slice_groups_minus1
        bw.ue(0)             # num_ref_idx_l0_default_active_minus1
        bw.ue(0)             # num_ref_idx_l1_default_active_minus1
        bw.write_bit(0)      # weighted_pred_flag
        bw.write(0, 2)       # weighted_bipred_idc
        bw.se(self.init_qp - 26)   # pic_init_qp_minus26
        bw.se(0)             # pic_init_qs_minus26
        bw.se(0)             # chroma_qp_index_offset
        bw.write_bit(1 if self.deblocking_control_present else 0)
        bw.write_bit(0)      # constrained_intra_pred_flag
        bw.write_bit(0)      # redundant_pic_cnt_present
        bw.rbsp_trailing_bits()
        return bw.getvalue()

    def to_nal(self) -> bytes:
        return annexb_nal(3, NAL_PPS, self.to_rbsp())

    @classmethod
    def parse_rbsp(cls, rbsp: bytes) -> "PPS":
        br = BitReader(rbsp)
        br.ue()
        br.ue()
        if br.read_bit():
            raise ValueError("CABAC streams not supported")
        br.read_bit()
        if br.ue() != 0:
            raise ValueError("slice groups not supported")
        br.ue()
        br.ue()
        br.read_bit()
        br.read(2)
        init_qp = br.se() + 26
        br.se()
        chroma_qp_off = br.se()
        if chroma_qp_off != 0:
            raise ValueError("chroma_qp_index_offset != 0 not supported")
        dbc = bool(br.read_bit())
        if br.read_bit():
            raise ValueError("constrained_intra_pred not supported")
        br.read_bit()
        return cls(init_qp=init_qp, deblocking_control_present=dbc)


@dataclasses.dataclass(frozen=True)
class SliceHeader:
    slice_type: int                 # SLICE_TYPE_I / SLICE_TYPE_P
    frame_num: int
    idr: bool
    qp: int
    idr_pic_id: int = 0
    first_mb: int = 0
    #: disable_deblocking_filter_idc (§7.4.3): 1 = off (the historical
    #: default — encoder recon needs no filter), 0 = §8.7 in-loop
    #: deblocking across the whole picture (the `deblock` RD feature),
    #: 2 = filter inside slices only (parsed, but neither emitted by
    #: this encoder nor decoded by the in-repo decoder).
    deblock_idc: int = 1

    @property
    def disable_deblocking(self) -> bool:
        return self.deblock_idc == 1

    def write(self, bw: BitWriter, sps: SPS, pps: PPS) -> None:
        bw.ue(self.first_mb)
        # +5 variant: all slices of this picture share the type
        bw.ue(self.slice_type + 5)
        bw.ue(0)                                        # pps id
        bw.write(self.frame_num % (1 << sps.log2_max_frame_num),
                 sps.log2_max_frame_num)
        if self.idr:
            bw.ue(self.idr_pic_id)
        if self.slice_type == SLICE_TYPE_P:
            bw.write_bit(0)      # num_ref_idx_active_override_flag
            bw.write_bit(0)      # ref_pic_list_modification_flag_l0
        if self.idr:
            bw.write_bit(0)      # no_output_of_prior_pics
            bw.write_bit(0)      # long_term_reference_flag
        elif self.slice_type == SLICE_TYPE_P:
            bw.write_bit(0)      # adaptive_ref_pic_marking_mode_flag
        bw.se(self.qp - pps.init_qp)                    # slice_qp_delta
        if pps.deblocking_control_present:
            bw.ue(self.deblock_idc)          # disable_deblocking_filter_idc
            if self.deblock_idc != 1:
                bw.se(0)                     # slice_alpha_c0_offset_div2
                bw.se(0)                     # slice_beta_offset_div2

    @classmethod
    def parse(cls, br: BitReader, sps: SPS, pps: PPS, nal_type: int,
              nal_ref_idc: int) -> "SliceHeader":
        first_mb = br.ue()
        st = br.ue()
        if st >= 5:
            st -= 5
        if st not in (SLICE_TYPE_I, SLICE_TYPE_P):
            raise ValueError(f"unsupported slice type {st}")
        br.ue()  # pps id
        frame_num = br.read(sps.log2_max_frame_num)
        idr = nal_type == NAL_SLICE_IDR
        idr_pic_id = br.ue() if idr else 0
        if st == SLICE_TYPE_P:
            if br.read_bit():               # num_ref_idx_active_override
                br.ue()
            if br.read_bit():               # ref_pic_list_modification_l0
                raise ValueError("ref pic list modification not supported")
        if nal_ref_idc != 0:
            if idr:
                br.read_bit()
                br.read_bit()
            elif st == SLICE_TYPE_P:
                if br.read_bit():
                    raise ValueError("adaptive ref marking not supported")
        qp = pps.init_qp + br.se()
        idc = 1
        if pps.deblocking_control_present:
            idc = br.ue()
            if idc != 1:
                off_a, off_b = br.se(), br.se()
                if off_a or off_b:
                    raise ValueError(
                        "nonzero deblock filter offsets not supported")
        return cls(slice_type=st, frame_num=frame_num, idr=idr, qp=qp,
                   idr_pic_id=idr_pic_id, first_mb=first_mb,
                   deblock_idc=idc)
