// Native video decode library (FFmpeg/libav) — the decord replacement.
//
// The reference reads videos through decord's C++ VideoReader
// (reference: src/datasets/video_dataset.py:203,268  vr.get_batch(indices)).
// This library provides the same capability for the host data pipeline:
// open a container, probe (frames, fps, geometry), and gather an arbitrary
// sorted frame-index batch as RGB24, with keyframe-aware seeking and
// sws_scale conversion/resize. Exposed as a C ABI for ctypes.
//
// Also includes a tiny mpeg4 encoder used to fabricate test/bench fixtures
// without an ffmpeg CLI.
//
// Build: python -m jepa_tpu_torch.native.build   (g++ -O2 -shared -fPIC ... -lav*);
// the library is also built at first use.

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libavutil/opt.h>
#include <libswscale/swscale.h>
}

#include <algorithm>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Decoder {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* codec = nullptr;
  SwsContext* sws = nullptr;
  int stream_index = -1;
  int width = 0, height = 0;
  double fps = 0.0;
  int64_t num_frames = 0;
  // frame cursor: presentation index of the next frame decode will produce
  int64_t next_frame = 0;
  std::string error;
};

int64_t estimate_frames(AVStream* st) {
  if (st->nb_frames > 0) return st->nb_frames;
  double fps = av_q2d(st->avg_frame_rate.num ? st->avg_frame_rate : st->r_frame_rate);
  if (st->duration > 0 && fps > 0) {
    return (int64_t)(st->duration * av_q2d(st->time_base) * fps + 0.5);
  }
  return 0;
}

int64_t pts_for_frame(const Decoder* d, int64_t frame) {
  AVStream* st = d->fmt->streams[d->stream_index];
  double fps = d->fps > 0 ? d->fps : 30.0;
  double t = frame / fps;
  return (int64_t)(t / av_q2d(st->time_base) + 0.5) + (st->start_time > 0 ? st->start_time : 0);
}

int64_t frame_for_pts(const Decoder* d, int64_t pts) {
  AVStream* st = d->fmt->streams[d->stream_index];
  double fps = d->fps > 0 ? d->fps : 30.0;
  int64_t start = st->start_time > 0 ? st->start_time : 0;
  double t = (pts - start) * av_q2d(st->time_base);
  return (int64_t)(t * fps + 0.5);
}

}  // namespace

extern "C" {

void* jdec_open_threads(const char* path, int threads) {
  auto* d = new Decoder();
  if (avformat_open_input(&d->fmt, path, nullptr, nullptr) < 0) {
    delete d;
    return nullptr;
  }
  if (avformat_find_stream_info(d->fmt, nullptr) < 0) {
    avformat_close_input(&d->fmt);
    delete d;
    return nullptr;
  }
  const AVCodec* dec = nullptr;
  d->stream_index = av_find_best_stream(d->fmt, AVMEDIA_TYPE_VIDEO, -1, -1, &dec, 0);
  if (d->stream_index < 0 || !dec) {
    avformat_close_input(&d->fmt);
    delete d;
    return nullptr;
  }
  AVStream* st = d->fmt->streams[d->stream_index];
  d->codec = avcodec_alloc_context3(dec);
  avcodec_parameters_to_context(d->codec, st->codecpar);
  // threads<=0 means codec auto (all cores); loader pools pass 1-2 so
  // parallelism comes from concurrent streams instead of one stream
  // hogging every core.
  d->codec->thread_count = threads > 0 ? threads : 0;
  d->codec->thread_type = FF_THREAD_FRAME | FF_THREAD_SLICE;
  if (avcodec_open2(d->codec, dec, nullptr) < 0) {
    avcodec_free_context(&d->codec);
    avformat_close_input(&d->fmt);
    delete d;
    return nullptr;
  }
  d->width = d->codec->width;
  d->height = d->codec->height;
  d->fps = av_q2d(st->avg_frame_rate.num ? st->avg_frame_rate : st->r_frame_rate);
  d->num_frames = estimate_frames(st);
  return d;
}

void* jdec_open(const char* path) { return jdec_open_threads(path, 0); }

int jdec_info(void* handle, long long* num_frames, double* fps, int* width, int* height) {
  if (!handle) return -1;
  auto* d = (Decoder*)handle;
  *num_frames = d->num_frames;
  *fps = d->fps;
  *width = d->width;
  *height = d->height;
  return 0;
}

// Decode frames at the given ascending indices into out (RGB24,
// [n, out_h, out_w, 3] C-contiguous). out_w/out_h of 0 use native size.
int jdec_read_frames(void* handle, const long long* indices, int n,
                     unsigned char* out, int out_w, int out_h) {
  if (!handle || n <= 0) return -1;
  auto* d = (Decoder*)handle;
  if (out_w <= 0) out_w = d->width;
  if (out_h <= 0) out_h = d->height;

  d->sws = sws_getCachedContext(d->sws, d->width, d->height, d->codec->pix_fmt,
                                out_w, out_h, AV_PIX_FMT_RGB24,
                                SWS_BILINEAR, nullptr, nullptr, nullptr);
  if (!d->sws) return -2;

  AVPacket* pkt = av_packet_alloc();
  AVFrame* frame = av_frame_alloc();
  int want = 0;  // next output slot
  int rc = 0;

  auto seek_to = [&](int64_t target_frame) {
    int64_t pts = pts_for_frame(d, target_frame);
    av_seek_frame(d->fmt, d->stream_index, pts, AVSEEK_FLAG_BACKWARD);
    avcodec_flush_buffers(d->codec);
    d->next_frame = -1;  // unknown until the first decoded pts
  };

  // Frames must be gathered in ascending order; seek when jumping backward
  // or far forward (> 3s worth of frames), else roll forward.
  int64_t first = indices[0];
  if (first < d->next_frame || d->next_frame < 0 ||
      first > d->next_frame + (int64_t)(3 * (d->fps > 0 ? d->fps : 30.0))) {
    seek_to(first);
  }

  bool eof_sent = false;
  while (want < n) {
    int recv = avcodec_receive_frame(d->codec, frame);
    if (recv == 0) {
      int64_t fidx;
      int64_t best_ts = frame->best_effort_timestamp;
      if (best_ts == AV_NOPTS_VALUE) {
        fidx = d->next_frame >= 0 ? d->next_frame : 0;
      } else {
        fidx = frame_for_pts(d, best_ts);
      }
      d->next_frame = fidx + 1;
      while (want < n && indices[want] <= fidx) {
        uint8_t* dst[1] = {out + (size_t)want * out_h * out_w * 3};
        int dst_stride[1] = {out_w * 3};
        sws_scale(d->sws, frame->data, frame->linesize, 0, d->height, dst, dst_stride);
        ++want;
      }
      av_frame_unref(frame);
      continue;
    }
    if (recv == AVERROR_EOF) {
      // pad remaining slots with the last produced frame (short videos)
      if (want == 0) { rc = -3; break; }
      while (want < n) {
        std::memcpy(out + (size_t)want * out_h * out_w * 3,
                    out + (size_t)(want - 1) * out_h * out_w * 3,
                    (size_t)out_h * out_w * 3);
        ++want;
      }
      break;
    }
    if (recv != AVERROR(EAGAIN)) { rc = -4; break; }

    // feed more packets
    int r = av_read_frame(d->fmt, pkt);
    if (r < 0) {
      if (!eof_sent) {
        avcodec_send_packet(d->codec, nullptr);
        eof_sent = true;
      } else {
        rc = -5;
        break;
      }
      continue;
    }
    if (pkt->stream_index == d->stream_index) {
      avcodec_send_packet(d->codec, pkt);
    }
    av_packet_unref(pkt);
  }

  av_frame_free(&frame);
  av_packet_free(&pkt);
  return rc == 0 ? want : rc;
}

void jdec_close(void* handle) {
  if (!handle) return;
  auto* d = (Decoder*)handle;
  if (d->sws) sws_freeContext(d->sws);
  if (d->codec) avcodec_free_context(&d->codec);
  if (d->fmt) avformat_close_input(&d->fmt);
  delete d;
}

// ---------------------------------------------------------------------------
// Encoders: arbitrary RGB24 frames -> mpeg4 (fixture generation / dataset
// synthesis), plus the deterministic moving-gradient test video built on it.
// ---------------------------------------------------------------------------

// data: packed RGB24 frames [num_frames, h, w, 3], row-major.
int jdec_encode_frames(const char* path, const uint8_t* data, int num_frames,
                       int w, int h, double fps) {
  AVFormatContext* fmt = nullptr;
  if (avformat_alloc_output_context2(&fmt, nullptr, nullptr, path) < 0 || !fmt)
    return -1;
  const AVCodec* enc = avcodec_find_encoder(AV_CODEC_ID_MPEG4);
  if (!enc) return -2;
  AVStream* st = avformat_new_stream(fmt, enc);
  AVCodecContext* c = avcodec_alloc_context3(enc);
  c->width = w;
  c->height = h;
  c->pix_fmt = AV_PIX_FMT_YUV420P;
  c->time_base = {1, (int)fps};
  c->framerate = {(int)fps, 1};
  c->bit_rate = 800000;
  c->gop_size = 12;
  if (fmt->oformat->flags & AVFMT_GLOBALHEADER)
    c->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  if (avcodec_open2(c, enc, nullptr) < 0) return -3;
  avcodec_parameters_from_context(st->codecpar, c);
  st->time_base = c->time_base;
  st->avg_frame_rate = c->framerate;
  if (!(fmt->oformat->flags & AVFMT_NOFILE)) {
    if (avio_open(&fmt->pb, path, AVIO_FLAG_WRITE) < 0) return -4;
  }
  if (avformat_write_header(fmt, nullptr) < 0) return -5;

  AVFrame* rgb = av_frame_alloc();
  rgb->format = AV_PIX_FMT_RGB24;
  rgb->width = w;
  rgb->height = h;
  av_frame_get_buffer(rgb, 0);
  AVFrame* yuv = av_frame_alloc();
  yuv->format = AV_PIX_FMT_YUV420P;
  yuv->width = w;
  yuv->height = h;
  av_frame_get_buffer(yuv, 0);
  SwsContext* sws = sws_getContext(w, h, AV_PIX_FMT_RGB24, w, h,
                                   AV_PIX_FMT_YUV420P, SWS_BILINEAR,
                                   nullptr, nullptr, nullptr);
  AVPacket* pkt = av_packet_alloc();

  auto flush = [&](AVFrame* f) -> int {
    if (avcodec_send_frame(c, f) < 0) return -6;
    while (true) {
      int r = avcodec_receive_packet(c, pkt);
      if (r == AVERROR(EAGAIN) || r == AVERROR_EOF) return 0;
      if (r < 0) return -7;
      // Without an explicit per-packet duration the mp4 muxer derives the
      // stream duration as last_pts - first_pts (one frame short), which
      // skews avg_frame_rate for short clips (12@30fps probes as 32.7) and
      // breaks timestamp-based random access near the tail.
      if (pkt->duration == 0) pkt->duration = 1;
      av_packet_rescale_ts(pkt, c->time_base, st->time_base);
      pkt->stream_index = st->index;
      av_interleaved_write_frame(fmt, pkt);
      av_packet_unref(pkt);
    }
  };

  for (int t = 0; t < num_frames; ++t) {
    av_frame_make_writable(rgb);
    const uint8_t* src = data + (size_t)t * h * w * 3;
    for (int y = 0; y < h; ++y) {
      std::memcpy(rgb->data[0] + y * rgb->linesize[0], src + (size_t)y * w * 3,
                  (size_t)w * 3);
    }
    sws_scale(sws, rgb->data, rgb->linesize, 0, h, yuv->data, yuv->linesize);
    yuv->pts = t;
    if (flush(yuv) < 0) return -8;
  }
  flush(nullptr);
  av_write_trailer(fmt);

  av_packet_free(&pkt);
  sws_freeContext(sws);
  av_frame_free(&rgb);
  av_frame_free(&yuv);
  avcodec_free_context(&c);
  if (!(fmt->oformat->flags & AVFMT_NOFILE)) avio_closep(&fmt->pb);
  avformat_free_context(fmt);
  return 0;
}

int jdec_encode_test_video(const char* path, int num_frames, int w, int h,
                           double fps, int seed) {
  std::vector<uint8_t> buf((size_t)num_frames * h * w * 3);
  for (int t = 0; t < num_frames; ++t) {
    uint8_t* f = buf.data() + (size_t)t * h * w * 3;
    for (int y = 0; y < h; ++y) {
      uint8_t* row = f + (size_t)y * w * 3;
      for (int x = 0; x < w; ++x) {
        row[x * 3 + 0] = (uint8_t)((x + 2 * t + seed) & 0xff);
        row[x * 3 + 1] = (uint8_t)((y + 3 * t + 2 * seed) & 0xff);
        row[x * 3 + 2] = (uint8_t)((x + y + t) & 0xff);
      }
    }
  }
  return jdec_encode_frames(path, buf.data(), num_frames, w, h, fps);
}

}  // extern "C"
