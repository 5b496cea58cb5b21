/* PlutoSDR hi-speed bulk-streaming host driver (the framework's native layer).
 *
 * Re-provides the component the reference ships as
 * src/libplutosdr/plutosdr_hi_speed_rx.c (719 lines, osmoplutosdr-
 * derived): a libusb userspace driver that claims the Pluto's raw
 * hi-speed bulk endpoint (exposed by the device-side gadget module, see
 * README.md) and delivers PLANAR int16 I/Q sample callbacks at 9.2 Msps.
 * Written from scratch against the PUBLIC libusb-1.0 synchronous API and
 * the binding surface io/vendor.py expects (plutosdr_open / set_* /
 * start_rx with planar transfers); no reference code is copied, and the
 * control wire protocol is OURS (documented below + in README.md) — the
 * device-side gadget implements the same requests.
 *
 * libusb is loaded at RUNTIME via dlopen (no -lusb link, no headers
 * needed at build time — only the documented stable ABI of the
 * synchronous entry points is used, so this file builds in minimal
 * environments and the test suite can substitute a fake libusb via
 * T2_LIBUSB_PATH to drive the full open/configure/stream/close flow).
 *
 * Wire protocol (vendor interface requests, bmRequestType 0x41 out /
 * 0xC1 in, little-endian payloads in the data stage):
 *   0x10 SET_RFBW         u32 Hz
 *   0x11 SET_SAMPLE_RATE  u32 Hz
 *   0x12 SET_RXLO         u64 Hz
 *   0x13 GAINCTL_MANUAL   (no data)
 *   0x14 SET_GAIN_MDB     u32 milli-dB
 *   0x15 CHANNEL_ENABLE   u32 channel, u32 enable
 *   0x16 BUFSTREAM_ENABLE u32 enable
 *   0x20 GET_INFO (in)    serial string (<= 64 bytes)
 * Samples stream on bulk-IN endpoint 0x81 as interleaved int16 I,Q
 * (12-bit left-justified in the low 12 bits, the AD9361 DMA format);
 * the driver deinterleaves into planar buffers for the callback.
 */
#include <dlfcn.h>
#include <pthread.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

/* ---- libusb-1.0 stable ABI subset (synchronous API only) ----------- */

typedef struct libusb_context libusb_context;
typedef struct libusb_device libusb_device;
typedef struct libusb_device_handle libusb_device_handle;

struct usb_descriptor { /* standard 18-byte USB device descriptor */
    uint8_t bLength, bDescriptorType;
    uint16_t bcdUSB;
    uint8_t bDeviceClass, bDeviceSubClass, bDeviceProtocol,
        bMaxPacketSize0;
    uint16_t idVendor, idProduct, bcdDevice;
    uint8_t iManufacturer, iProduct, iSerialNumber, bNumConfigurations;
} __attribute__((packed));

static struct {
    void *dl;
    int (*init)(libusb_context **);
    void (*exit_)(libusb_context *);
    long (*get_device_list)(libusb_context *, libusb_device ***);
    void (*free_device_list)(libusb_device **, int);
    int (*get_device_descriptor)(libusb_device *, struct usb_descriptor *);
    int (*open)(libusb_device *, libusb_device_handle **);
    void (*close)(libusb_device_handle *);
    int (*claim_interface)(libusb_device_handle *, int);
    int (*release_interface)(libusb_device_handle *, int);
    int (*bulk_transfer)(libusb_device_handle *, unsigned char,
                         unsigned char *, int, int *, unsigned);
    int (*control_transfer)(libusb_device_handle *, uint8_t, uint8_t,
                            uint16_t, uint16_t, unsigned char *, uint16_t,
                            unsigned);
} U;

static int u_state = 0; /* 0 = unloaded, 1 = ok, <0 = failed (sticky) */

static int u_load(void) {
    if (u_state) return u_state > 0 ? 0 : u_state;
    const char *path = getenv("T2_LIBUSB_PATH");
    U.dl = dlopen(path && *path ? path : "libusb-1.0.so.0",
                  RTLD_NOW | RTLD_LOCAL);
    if (!U.dl) { u_state = -1; return -1; }
#define SYM(field, name) \
    *(void **)&U.field = dlsym(U.dl, name); \
    if (!U.field) { u_state = -2; return -2; }
    SYM(init, "libusb_init")
    SYM(exit_, "libusb_exit")
    SYM(get_device_list, "libusb_get_device_list")
    SYM(free_device_list, "libusb_free_device_list")
    SYM(get_device_descriptor, "libusb_get_device_descriptor")
    SYM(open, "libusb_open")
    SYM(close, "libusb_close")
    SYM(claim_interface, "libusb_claim_interface")
    SYM(release_interface, "libusb_release_interface")
    SYM(bulk_transfer, "libusb_bulk_transfer")
    SYM(control_transfer, "libusb_control_transfer")
#undef SYM
    u_state = 1;
    return 0;
}

static uint16_t env_u16(const char *name, uint16_t dflt) {
    const char *v = getenv(name);
    return v && *v ? (uint16_t)strtoul(v, NULL, 0) : dflt;
}

/* Pluto default VID/PID; the gadget module keeps them.  Overridable for
 * forks/tests via T2_PLUTO_VID / T2_PLUTO_PID. */
#define DFLT_VID 0x0456
#define DFLT_PID 0xb673

#define EP_SAMPLES 0x81
#define IFACE 0
#define CTRL_OUT 0x41
#define CTRL_IN 0xC1
#define REQ_SET_RFBW 0x10
#define REQ_SET_SAMPLE_RATE 0x11
#define REQ_SET_RXLO 0x12
#define REQ_GAINCTL_MANUAL 0x13
#define REQ_SET_GAIN_MDB 0x14
#define REQ_CHANNEL_ENABLE 0x15
#define REQ_BUFSTREAM_ENABLE 0x16
#define REQ_GET_INFO 0x20
#define CTRL_TIMEOUT_MS 1000
#define BULK_TIMEOUT_MS 1000
/* 256 KiB per transfer = 65536 IQ samples ~ 7 ms at 9.2 Msps; two
 * in-flight-sized planar buffers double-buffer the callback. */
#define CHUNK_BYTES (256 * 1024)
#define CHUNK_SAMPLES (CHUNK_BYTES / 4)

/* ---- the binding-facing API (io/vendor.py prototypes) -------------- */

typedef struct {
    uint8_t serial_number[2048];
    int serial_number_len;
    int samples_type; /* 0 = IQ int16 */
    uint32_t len_out; /* samples per callback */
} plutosdr_info_t;

struct plutosdr_transfer;
typedef int (*plutosdr_cb_t)(struct plutosdr_transfer *);

typedef struct plutosdr_device {
    libusb_context *ctx;
    libusb_device_handle *h;
    pthread_t thread;
    int thread_valid; /* a created thread must be joined exactly once,
                       * even when it stopped ITSELF (unplug / cb stop) */
    volatile int streaming;
    plutosdr_cb_t cb;
    void *cb_ctx;
    unsigned char raw[CHUNK_BYTES];
    int16_t plane_i[2][CHUNK_SAMPLES];
    int16_t plane_q[2][CHUNK_SAMPLES];
} plutosdr_device_t;

typedef struct plutosdr_transfer {
    plutosdr_device_t *device;
    void *ctx;
    int16_t *i_samples;
    int16_t *q_samples;
    int sample_count;
} plutosdr_transfer_t;

static libusb_device *find_dev(libusb_device **list, long n) {
    uint16_t vid = env_u16("T2_PLUTO_VID", DFLT_VID);
    uint16_t pid = env_u16("T2_PLUTO_PID", DFLT_PID);
    for (long i = 0; i < n; ++i) {
        struct usb_descriptor d;
        if (U.get_device_descriptor(list[i], &d) == 0
            && d.idVendor == vid && d.idProduct == pid)
            return list[i];
    }
    return NULL;
}

uint32_t plutosdr_get_device_count(void) {
    if (u_load()) return 0;
    libusb_context *ctx = NULL;
    if (U.init(&ctx)) return 0;
    libusb_device **list = NULL;
    long n = U.get_device_list(ctx, &list);
    uint32_t count = 0;
    uint16_t vid = env_u16("T2_PLUTO_VID", DFLT_VID);
    uint16_t pid = env_u16("T2_PLUTO_PID", DFLT_PID);
    for (long i = 0; i < n; ++i) {
        struct usb_descriptor d;
        if (U.get_device_descriptor(list[i], &d) == 0
            && d.idVendor == vid && d.idProduct == pid)
            ++count;
    }
    if (list) U.free_device_list(list, 1);
    U.exit_(ctx);
    return count;
}

int plutosdr_open(plutosdr_device_t **out, uint8_t index,
                  plutosdr_info_t *info) {
    (void)index; /* first matching device; multi-device not needed */
    if (u_load()) return -10;
    plutosdr_device_t *d = calloc(1, sizeof(*d));
    if (!d) return -11;
    if (U.init(&d->ctx)) { free(d); return -12; }
    libusb_device **list = NULL;
    long n = U.get_device_list(d->ctx, &list);
    libusb_device *dev = find_dev(list, n);
    int err = dev ? U.open(dev, &d->h) : -13;
    if (list) U.free_device_list(list, 1);
    if (err || !d->h) { U.exit_(d->ctx); free(d); return err ? err : -14; }
    if ((err = U.claim_interface(d->h, IFACE))) {
        U.close(d->h); U.exit_(d->ctx); free(d);
        return err;
    }
    if (info) {
        memset(info, 0, sizeof(*info));
        unsigned char buf[64];
        int got = U.control_transfer(d->h, CTRL_IN, REQ_GET_INFO, 0, 0,
                                     buf, sizeof(buf), CTRL_TIMEOUT_MS);
        if (got > 0) {
            memcpy(info->serial_number, buf, (size_t)got);
            info->serial_number_len = got;
        }
        info->samples_type = 0;
        info->len_out = CHUNK_SAMPLES;
    }
    *out = d;
    return 0;
}

static int ctrl_out(plutosdr_device_t *d, uint8_t req,
                    const void *data, uint16_t len) {
    int got = U.control_transfer(d->h, CTRL_OUT, req, 0, 0,
                                 (unsigned char *)data, len,
                                 CTRL_TIMEOUT_MS);
    return got == (int)len ? 0 : (got < 0 ? got : -1);
}

int plutosdr_set_rfbw(plutosdr_device_t *d, uint32_t hz) {
    return ctrl_out(d, REQ_SET_RFBW, &hz, 4);
}
int plutosdr_set_sample_rate(plutosdr_device_t *d, uint32_t hz) {
    return ctrl_out(d, REQ_SET_SAMPLE_RATE, &hz, 4);
}
int plutosdr_set_rxlo(plutosdr_device_t *d, uint64_t hz) {
    return ctrl_out(d, REQ_SET_RXLO, &hz, 8);
}
int plutosdr_set_gainctl_manual(plutosdr_device_t *d) {
    return ctrl_out(d, REQ_GAINCTL_MANUAL, NULL, 0);
}
int plutosdr_set_gain_mdb(plutosdr_device_t *d, uint32_t mdb) {
    return ctrl_out(d, REQ_SET_GAIN_MDB, &mdb, 4);
}
int plutosdr_buffer_channel_enable(plutosdr_device_t *d, uint32_t ch,
                                   uint32_t on) {
    uint32_t payload[2] = {ch, on};
    return ctrl_out(d, REQ_CHANNEL_ENABLE, payload, 8);
}
int plutosdr_bufstream_enable(plutosdr_device_t *d, uint32_t on) {
    return ctrl_out(d, REQ_BUFSTREAM_ENABLE, &on, 4);
}

#define LIBUSB_ERROR_TIMEOUT (-7)
#define MAX_HARD_ERRORS 8

static void *rx_thread(void *arg) {
    plutosdr_device_t *d = arg;
    int which = 0;
    int hard_errors = 0;
    while (d->streaming) {
        int got = 0;
        int err = U.bulk_transfer(d->h, EP_SAMPLES, d->raw, CHUNK_BYTES,
                                  &got, BULK_TIMEOUT_MS);
        if (err && got <= 0) {
            if (!d->streaming) break;
            /* timeouts retry forever (a stalled endpoint is the
             * consumer's stall_timeout problem); any other error
             * repeated MAX_HARD_ERRORS times (unplug, babble) ends the
             * stream instead of spinning */
            if (err != LIBUSB_ERROR_TIMEOUT
                && ++hard_errors >= MAX_HARD_ERRORS) {
                d->streaming = 0;
                break;
            }
            continue;
        }
        hard_errors = 0;
        int n = got / 4; /* interleaved int16 IQ pairs */
        if (n <= 0) continue;
        const int16_t *s = (const int16_t *)d->raw;
        int16_t *pi = d->plane_i[which];
        int16_t *pq = d->plane_q[which];
        for (int k = 0; k < n; ++k) {
            pi[k] = s[2 * k];
            pq[k] = s[2 * k + 1];
        }
        plutosdr_transfer_t t = {d, d->cb_ctx, pi, pq, n};
        which ^= 1; /* the callback may hold the planes until we wrap */
        if (d->cb && d->cb(&t))
            d->streaming = 0;
    }
    return NULL;
}

int plutosdr_start_rx(plutosdr_device_t *d, plutosdr_cb_t cb, void *ctx) {
    if (!d || d->streaming) return -1;
    if (d->thread_valid) { /* reap a self-stopped previous thread */
        pthread_join(d->thread, NULL);
        d->thread_valid = 0;
    }
    d->cb = cb;
    d->cb_ctx = ctx;
    d->streaming = 1;
    if (pthread_create(&d->thread, NULL, rx_thread, d)) {
        d->streaming = 0;
        return -2;
    }
    d->thread_valid = 1;
    return 0;
}

int plutosdr_stop_rx(plutosdr_device_t *d) {
    if (!d) return -1;
    d->streaming = 0;
    if (d->thread_valid) {
        pthread_join(d->thread, NULL);
        d->thread_valid = 0;
    }
    return 0;
}

int plutosdr_close(plutosdr_device_t *d) {
    if (!d) return -1;
    plutosdr_stop_rx(d);
    U.release_interface(d->h, IFACE);
    U.close(d->h);
    U.exit_(d->ctx);
    free(d);
    return 0;
}
