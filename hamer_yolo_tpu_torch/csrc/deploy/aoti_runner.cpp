// aoti_runner: standalone C++ runner for the port's AOTInductor packages.
//
// Counterpart of cpp/src/pjrt_runner.cpp (hyt_run) for the PyTorch port:
// where hyt_run dlopens a PJRT plugin and deserializes an XLA executable,
// this program loads a package written by
// hamer_yolo_tpu_torch/tools/export_executable.py with
// torch::inductor::AOTIModelPackageLoader, feeds it, runs it on the card and
// prints what comes out, with no Python in the loop. The package calls K1
// and K2 as the operators hyt_port::* of csrc/torch_ops.cpp, so the operator
// library (HYT_OPS_LIBRARY, its path fixed when the runner is built by
// hamer_yolo_tpu_torch.cpp.build_runner) is loaded first.
//
// Usage:
//   aoti_runner <model.pt2> [input.meta] [image[.ppm|.raw] [HxW]]
//   aoti_runner <model.pt2> <input.meta> --serve
//
// input.meta lines: "<dtype> <d0,d1,...>" per program input, e.g.
//   f32 1,640,640,3
// Missing meta => runs with no inputs; inputs not fed are zeros.
//
// Images (one-shot and --serve): *.ppm, binary P6 (RGB), or a raw HxWx3
// uint8 BGR dump, "f.raw HxW" one-shot and "f.raw:HxW" in --serve mode.
// A (1, S, S, 3) first input (the yolo and hamer programs) takes the frame
// letterboxed to S with the host library's hyt_letterbox, RGB, in [0, 1],
// as hyt_run feeds it. An (H, W, 3) first input (the frame program) takes
// the frame as it is, BGR 0..255, at the top left of an H x W zero canvas;
// then a second input of shape (2) gets the frame's (h, w) and a third of
// shape (3, 3) the pipeline's default intrinsics (pipeline/runner.py).
//
// --serve: prints "ready", then reads one image path a line from stdin,
// runs the hot package and prints ONE JSON line a frame:
//   {"image": ..., "ms": ..., "detections": [{"cls":..,"score":..,
//    "box":[x1,y1,x2,y2]}, ...]}
// for the 4-output detector schema (boxes, scores, classes, valid), per-output
// checksums otherwise. "quit" or EOF exits.
//
// A package for the card on a host without one is refused with a message
// and a non-zero exit: nothing falls back to the CPU.

#include <dlfcn.h>

#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <exception>
#include <fstream>
#include <iostream>
#include <memory>
#include <sstream>
#include <string>
#include <vector>

#include <ATen/ATen.h>
#include <torch/csrc/inductor/aoti_package/model_package_loader.h>
#include <torch/cuda.h>

#include "hyt.h"

#ifndef HYT_OPS_LIBRARY
#error "build with -DHYT_OPS_LIBRARY=\"<path of the operator library>\""
#endif

namespace {

struct ArgSpec {
  at::ScalarType type;
  std::vector<int64_t> dims;
};

std::vector<ArgSpec> ParseMeta(const char* path) {
  std::vector<ArgSpec> specs;
  std::ifstream f(path);
  if (!f) return specs;
  std::string dtype, dims_str;
  while (f >> dtype >> dims_str) {
    ArgSpec s;
    if (dtype == "f32") {
      s.type = at::kFloat;
    } else if (dtype == "i32") {
      s.type = at::kInt;
    } else if (dtype == "bf16") {
      s.type = at::kBFloat16;
    } else {
      fprintf(stderr, "unknown dtype %s\n", dtype.c_str());
      exit(1);
    }
    std::stringstream ds(dims_str);
    std::string tok;
    while (std::getline(ds, tok, ',')) s.dims.push_back(std::stoll(tok));
    specs.push_back(std::move(s));
  }
  return specs;
}

// ---------------------------------------------------------------------------
// Image loading: binary P6 PPM (RGB) or raw uint8 BGR dump.
// ---------------------------------------------------------------------------

bool LoadPPM(const std::string& path, int* h, int* w, std::vector<uint8_t>* rgb) {
  std::ifstream f(path, std::ios::binary);
  if (!f) {
    fprintf(stderr, "cannot open %s\n", path.c_str());
    return false;
  }
  std::string magic;
  f >> magic;
  if (magic != "P6") {
    fprintf(stderr, "%s: not a binary P6 PPM\n", path.c_str());
    return false;
  }
  auto next_int = [&f](int* out) {
    for (;;) {
      f >> std::ws;
      if (f.peek() == '#') {
        std::string line;
        std::getline(f, line);
        continue;
      }
      return bool(f >> *out);
    }
  };
  int maxval = 0;
  if (!next_int(w) || !next_int(h) || !next_int(&maxval) || maxval != 255) {
    fprintf(stderr, "%s: bad PPM header\n", path.c_str());
    return false;
  }
  f.get();  // the one whitespace byte after maxval
  rgb->resize((size_t)(*h) * (*w) * 3);
  f.read(reinterpret_cast<char*>(rgb->data()), rgb->size());
  if ((size_t)f.gcount() != rgb->size()) {
    fprintf(stderr, "%s: truncated PPM payload\n", path.c_str());
    return false;
  }
  return true;
}

// "f.ppm" or "f.raw:HxW" (BGR raw, converted to RGB here).
bool LoadImageAny(const std::string& spec, int* h, int* w, std::vector<uint8_t>* rgb) {
  const size_t colon = spec.rfind(':');
  if (colon != std::string::npos && sscanf(spec.c_str() + colon + 1, "%dx%d", h, w) == 2) {
    const std::string path = spec.substr(0, colon);
    std::ifstream f(path, std::ios::binary);
    if (!f) {
      fprintf(stderr, "cannot open %s\n", path.c_str());
      return false;
    }
    std::vector<uint8_t> bgr((size_t)(*h) * (*w) * 3);
    f.read(reinterpret_cast<char*>(bgr.data()), bgr.size());
    if ((size_t)f.gcount() != bgr.size()) {
      fprintf(stderr, "%s: raw size mismatch (want %dx%dx3)\n", path.c_str(), *h, *w);
      return false;
    }
    rgb->resize(bgr.size());
    for (size_t i = 0; i < bgr.size(); i += 3) {
      (*rgb)[i + 0] = bgr[i + 2];
      (*rgb)[i + 1] = bgr[i + 1];
      (*rgb)[i + 2] = bgr[i + 0];
    }
    return true;
  }
  return LoadPPM(spec, h, w, rgb);
}

// ---------------------------------------------------------------------------
// Feeding a frame to the program's inputs.
// ---------------------------------------------------------------------------

struct Letterbox {
  float r = 1.f, dw = 0.f, dh = 0.f;
};

// Fills the host copies of the inputs from an RGB frame (see the header);
// returns false where the frame does not fit the program.
bool FeedFrame(const std::vector<uint8_t>& rgb, int h, int w, const std::vector<ArgSpec>& specs,
               std::vector<at::Tensor>* host, Letterbox* lb) {
  const std::vector<int64_t>& d = specs[0].dims;
  if (d.size() == 4 && d[0] == 1 && d[1] == d[2] && d[3] == 3 && specs[0].type == at::kFloat) {
    const int S = (int)d[1];
    std::vector<float> boxed((size_t)S * S * 3);
    hyt_letterbox(rgb.data(), h, w, S, boxed.data(), &lb->r, &lb->dw, &lb->dh);
    float* dst = (*host)[0].data_ptr<float>();
    for (size_t i = 0; i < boxed.size(); ++i) dst[i] = boxed[i] / 255.f;
    return true;
  }
  if (d.size() == 3 && d[2] == 3 && specs[0].type == at::kFloat) {
    if (h > d[0] || w > d[1]) {
      fprintf(stderr, "frame %dx%d does not fit the program's %lldx%lld input\n", h, w,
              (long long)d[0], (long long)d[1]);
      return false;
    }
    at::Tensor& img = (*host)[0];
    img.zero_();
    float* dst = img.data_ptr<float>();
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x)
        for (int c = 0; c < 3; ++c)  // RGB -> BGR, 0..255
          dst[((size_t)y * d[1] + x) * 3 + c] = rgb[((size_t)y * w + x) * 3 + (2 - c)];
    if (specs.size() > 1 && specs[1].dims == std::vector<int64_t>{2}) {
      float* hw = (*host)[1].data_ptr<float>();
      hw[0] = (float)h;
      hw[1] = (float)w;
    }
    if (specs.size() > 2 && specs[2].dims == std::vector<int64_t>{3, 3}) {
      // pipeline/runner.default_intrinsics: f = 5000/256 max(h, w), centre
      float* K = (*host)[2].data_ptr<float>();
      const float f = (float)(5000.0 / 256.0 * std::max(h, w));
      const float Kv[9] = {f, 0.f, w / 2.f, 0.f, f, h / 2.f, 0.f, 0.f, 1.f};
      std::memcpy(K, Kv, sizeof Kv);
    }
    return true;
  }
  fprintf(stderr, "the program's first input is not an image\n");
  return false;
}

// ---------------------------------------------------------------------------
// Running and printing.
// ---------------------------------------------------------------------------

// Runs the package once and copies every output to the host; returns the
// wall ms of the two together (the copies wait for the card).
double RunOnce(torch::inductor::AOTIModelPackageLoader& loader,
               const std::vector<at::Tensor>& host, const at::Device& device,
               std::vector<at::Tensor>* outputs) {
  const auto t0 = std::chrono::steady_clock::now();
  std::vector<at::Tensor> inputs;
  for (const at::Tensor& t : host) inputs.push_back(t.to(device));
  std::vector<at::Tensor> out = loader.run(inputs);
  outputs->clear();
  for (const at::Tensor& t : out) outputs->push_back(t.cpu());
  return std::chrono::duration<double, std::milli>(std::chrono::steady_clock::now() - t0)
      .count();
}

// Detector-schema (boxes, scores, classes, valid) JSON, letterbox-unmapped.
// Returns false if the outputs have another schema.
bool PrintDetectionsJSON(const std::string& image, const std::vector<at::Tensor>& out,
                         const Letterbox& lb, double ms) {
  if (out.size() != 4 || out[0].scalar_type() != at::kFloat || out[0].dim() < 2 ||
      out[0].size(-1) != 4)
    return false;
  const int64_t n = out[0].numel() / 4;
  if (out[1].scalar_type() != at::kFloat || out[1].numel() != n ||
      out[2].scalar_type() != at::kInt || out[2].numel() != n ||
      out[3].scalar_type() != at::kBool || out[3].numel() != n)
    return false;
  const at::Tensor b = out[0].contiguous(), s = out[1].contiguous(), c = out[2].contiguous(),
                   v = out[3].contiguous();
  const float* boxes = b.data_ptr<float>();
  const float* scores = s.data_ptr<float>();
  const int32_t* classes = c.data_ptr<int32_t>();
  const bool* valid = v.data_ptr<bool>();
  printf("{\"image\": \"%s\", \"ms\": %.2f, \"detections\": [", image.c_str(), ms);
  int kept = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (!valid[i]) continue;
    const float x1 = (boxes[i * 4 + 0] - lb.dw) / lb.r;
    const float y1 = (boxes[i * 4 + 1] - lb.dh) / lb.r;
    const float x2 = (boxes[i * 4 + 2] - lb.dw) / lb.r;
    const float y2 = (boxes[i * 4 + 3] - lb.dh) / lb.r;
    printf("%s{\"cls\": %d, \"score\": %.4f, \"box\": [%.1f, %.1f, %.1f, %.1f]}",
           kept ? ", " : "", classes[i], scores[i], x1, y1, x2, y2);
    ++kept;
  }
  printf("]}\n");
  fflush(stdout);
  return true;
}

double Checksum(const at::Tensor& t) { return t.to(at::kDouble).sum().item<double>(); }

void PrintChecksumsJSON(const std::string& image, const std::vector<at::Tensor>& out,
                        double ms) {
  printf("{\"image\": \"%s\", \"ms\": %.2f, \"outputs\": [", image.c_str(), ms);
  for (size_t i = 0; i < out.size(); ++i) printf("%s%.4f", i ? ", " : "", Checksum(out[i]));
  printf("]}\n");
  fflush(stdout);
}

void PrintResult(const std::string& image, const std::vector<at::Tensor>& out,
                 const Letterbox& lb, double ms) {
  if (!PrintDetectionsJSON(image, out, lb, ms)) PrintChecksumsJSON(image, out, ms);
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 2 || argv[1][0] == '-') {
    fprintf(stderr,
            "usage: %s <model.pt2> [input.meta] [image[.ppm|.raw] [HxW] | --serve]\n",
            argv[0]);
    return 2;
  }
  bool serve = false;
  for (int i = 2; i < argc; ++i)
    if (strcmp(argv[i], "--serve") == 0) serve = true;

  // The operators hyt_port::* the package calls (csrc/torch_ops.cpp).
  if (!dlopen(HYT_OPS_LIBRARY, RTLD_NOW | RTLD_GLOBAL)) {
    fprintf(stderr,
            "cannot load the operator library %s (%s): build it first, "
            "hamer_yolo_tpu_torch.ops.torch_ops.build()\n",
            HYT_OPS_LIBRARY, dlerror());
    return 1;
  }
  std::unique_ptr<torch::inductor::AOTIModelPackageLoader> loader;
  std::string device_key;
  try {
    loader = std::make_unique<torch::inductor::AOTIModelPackageLoader>(argv[1]);
    device_key = loader->get_metadata()["AOTI_DEVICE_KEY"];
  } catch (const std::exception& e) {
    fprintf(stderr, "cannot load %s on this host: %s\n", argv[1], e.what());
    return 1;
  }
  if (device_key.empty()) device_key = "cpu";
  const at::Device device(device_key);
  if (device.is_cuda() && torch::cuda::device_count() == 0) {
    fprintf(stderr, "%s is a package for the card, and this host has none\n", argv[1]);
    return 1;
  }
  fprintf(stderr, "package loaded: %s on %s\n", argv[1], device_key.c_str());

  const std::vector<ArgSpec> specs =
      argc > 2 && argv[2][0] != '-' ? ParseMeta(argv[2]) : std::vector<ArgSpec>();
  std::vector<at::Tensor> host;
  for (const ArgSpec& s : specs) host.push_back(at::zeros(s.dims, at::dtype(s.type)));
  fprintf(stderr, "num inputs: %zu\n", specs.size());
  std::vector<at::Tensor> outputs;

  try {
    if (serve) {
      if (specs.empty()) {
        fprintf(stderr, "--serve needs an input.meta with the image input\n");
        return 2;
      }
      RunOnce(*loader, host, device, &outputs);  // warm the package first
      printf("ready\n");
      fflush(stdout);
      std::string line;
      while (std::getline(std::cin, line)) {
        if (line.empty()) continue;
        if (line == "quit" || line == "exit") break;
        int ih = 0, iw = 0;
        std::vector<uint8_t> rgb;
        Letterbox lb;
        if (!LoadImageAny(line, &ih, &iw, &rgb) || !FeedFrame(rgb, ih, iw, specs, &host, &lb)) {
          printf("{\"image\": \"%s\", \"error\": \"load failed\"}\n", line.c_str());
          fflush(stdout);
          continue;
        }
        const double ms = RunOnce(*loader, host, device, &outputs);
        PrintResult(line, outputs, lb, ms);
      }
      fprintf(stderr, "serve loop done\n");
      return 0;
    }

    // One-shot: an optional image into the first input.
    Letterbox lb;
    bool have_image = false;
    std::string image;
    if (argc > 3 && !specs.empty()) {
      image = argv[3];
      if (argc > 4) image += std::string(":") + argv[4];  // "f.raw HxW"
      int ih = 0, iw = 0;
      std::vector<uint8_t> rgb;
      if (!LoadImageAny(image, &ih, &iw, &rgb) || !FeedFrame(rgb, ih, iw, specs, &host, &lb))
        return 1;
      fprintf(stderr, "image %dx%d fed (r=%.4f pad %.1f,%.1f)\n", ih, iw, lb.r, lb.dw, lb.dh);
      have_image = true;
    }
    double ms = 0;
    for (int iter = 0; iter < 3; ++iter) {
      ms = RunOnce(*loader, host, device, &outputs);
      printf("iter %d: %.2f ms\n", iter, ms);
    }
    for (size_t i = 0; i < outputs.size(); ++i) {
      printf("output %zu: dims=[", i);
      for (int64_t d = 0; d < outputs[i].dim(); ++d)
        printf("%s%lld", d ? "," : "", (long long)outputs[i].size(d));
      printf("] dtype=%s bytes=%lld checksum=%.4f\n", c10::toString(outputs[i].scalar_type()),
             (long long)outputs[i].nbytes(), Checksum(outputs[i]));
    }
    if (have_image) PrintResult(image, outputs, lb, ms);
  } catch (const std::exception& e) {
    fprintf(stderr, "run failed: %s\n", e.what());
    return 1;
  }
  printf("OK\n");
  return 0;
}
